"""The whole-rung and whole-ladder solvers of the port
(varanneal_tpu_torch/kernels/solve.py: K2 and K3, whose plain versions
run on the CPU) against the JAX package's Pallas kernels
(varanneal_tpu/kernels/solve_pallas.py, in interpret mode, as
tests/test_solve_pallas.py runs them): on short rung solves the same
niter, nfev and status per member; over a short ladder the per-rung
action, the endpoint and the summed iterations. Also the rung_solver
hook of the port's ladder, the solvers' envelope, and the port's bench
(varanneal_tpu_torch/bench.py) on the CPU."""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu.kernels import solve_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax

from varanneal_tpu_torch import bench
from varanneal_tpu_torch.anneal import run_ladder
from varanneal_tpu_torch.anneal.ladder import rung_rf
from varanneal_tpu_torch.kernels import ag, solve
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import pack, spec_from_reference
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.parallel import random_ensemble_inits
from varanneal_tpu_torch.twin import lorenz96_twin


@pytest.fixture(autouse=True)
def _interp():
    solve_pallas.set_interpret(True)
    yield
    solve_pallas.set_interpret(False)


@pytest.fixture(scope="module")
def problem():
    """The data and RM rounded to f32: the Pallas kernels embed both in
    f32 whatever the solve's dtype, so only then do the two packages
    solve the same f64 problem."""
    tw = lorenz96_twin(D=20, N_data=41, n_obs=8)
    tw["Y"] = tw["Y"].astype(np.float32).astype(np.float64)
    tw["RM"] = float(np.float32(tw["RM"]))
    sj = build_spec_jax(lorenz96_jax, 20, tw["Y"], tw["t"], tw["Lidx"],
                        tw["RM"], disc="trapezoid", P=np.array([4.0]),
                        pidx=[0])
    st = spec_from_reference(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)},
        lorenz96)
    return tw, sj, st


SHORT = dict(maxiter=30, m=5, pgtol=1e-4, ftol=1e-6)


@pytest.mark.parametrize("dtype,xtol", [(np.float32, 2e-4),
                                        (np.float64, 1e-8)])
def test_rung_solver_matches_jax(problem, dtype, xtol):
    """Short solves (converged and stopped at maxiter) from data-informed
    draws at five rungs of the bench's ladder: identical niter, nfev and
    status. f32: f to 1e-4 relative and x to 2e-4 absolute (the bound
    tests/test_solve_pallas.py holds the JAX kernel to against its own
    XLA loop); f64: x to 1e-8 relative. β 15 and 20 are flat along the
    unobserved components, and an f32 solve stopped at pgtol 1e-4 ends
    there as far from the f64 solve of the same inputs (up to 1.2e-3 in
    f) as from the other f32 solve: f32 f is held there to the larger of
    1e-4 and the JAX f32 solve's own distance from the port's f64 solve,
    and f32 x is compared only at the other rungs."""
    tw, sj, st = problem
    rng = np.random.default_rng(0)
    X0 = random_ensemble_inits(st, 2, seed=5, dtype=dtype)
    X0 = X0 + rng.normal(0, 0.5, X0.shape).astype(dtype)
    rf0 = dtype(4e-6 * tw["RM"])
    jsolve = solve_pallas.make_rung_solver(sj, OptsJax(**SHORT))
    psolve = solve.make_rung_solver(st, LBFGSOptions(**SHORT), device="cpu")
    flat = (15, 20)
    for beta in (0, *flat, 30, 60):
        rf = rung_rf(rf0, 1.5, beta, torch.float32 if dtype == np.float32
                     else torch.float64)
        rp = psolve(torch.tensor(X0), rf)
        if dtype == np.float32 and beta in flat:
            f64 = psolve(torch.tensor(X0, dtype=torch.float64), rf).f
        for b in range(2):
            rj = jsolve(jnp.asarray(X0[b]), dtype(rf))
            assert int(rp.niter[b]) == int(rj.niter) > 0
            assert int(rp.nfev[b]) == int(rj.nfev)
            assert int(rp.status[b]) == int(rj.status)
            xj = np.asarray(rj.x)
            if dtype == np.float32:
                ftol = 1e-4
                if beta in flat:
                    ftol = max(ftol, abs(float(rj.f) - float(f64[b]))
                               / abs(float(f64[b])))
                else:
                    np.testing.assert_allclose(rp.x[b].numpy(), xj,
                                               atol=xtol)
                np.testing.assert_allclose(float(rp.f[b]), float(rj.f),
                                           rtol=ftol)
            else:
                scale = max(np.abs(xj).max(), 1.0)
                np.testing.assert_allclose(rp.x[b].numpy() / scale,
                                           xj / scale, rtol=0, atol=xtol)


def test_ladder_solver_matches_jax(problem):
    """B=2 members, 5 rungs in f32 from near the twin's truth at
    rf0 = RM: A to 5e-4 relative, XP to 2e-3 absolute and the summed
    niter equal (the rule of tests/test_solve_pallas.py's ladder parity).
    From random paths the bench's own low rungs converge at once, and its
    higher ones run to maxiter on rungs that f32 rounding alone steers
    apart; near the truth every rung is a well-posed solve."""
    tw, sj, st = problem
    opts = dict(maxiter=200, m=5, pgtol=1e-4, ftol=1e-6)
    rng = np.random.default_rng(1)
    X0 = np.stack([pack(st, tw["traj"] + 0.3 * rng.normal(
        size=tw["traj"].shape), np.array([tw["F"] + 0.5 * rng.normal()]))
        for _ in range(2)]).astype(np.float32)
    rf0 = np.float32(tw["RM"])
    betas = np.arange(5)
    rfs = np.array([rung_rf(rf0, 1.5, b, torch.float32) for b in betas])
    jl = solve_pallas.make_ladder_solver(sj, OptsJax(**opts), len(betas))
    xj, rj = jax.jit(jax.vmap(lambda z: jl(z, jnp.asarray(
        rfs, jnp.float32))))(jnp.asarray(X0))
    pl = solve.make_ladder_solver(st, LBFGSOptions(**opts), len(betas),
                                  device="cpu")
    xp, rp = pl(torch.tensor(X0), rfs)
    assert set(rp) == {"A", "ME", "FE", "pgnorm", "niter", "nfev",
                       "status"}
    assert rp["A"].shape == (2, len(betas))
    assert int(rp["niter"].sum()) == int(np.asarray(rj["niter"]).sum()) > 0
    np.testing.assert_allclose(rp["A"].numpy(), np.asarray(rj["A"]),
                               rtol=5e-4)
    np.testing.assert_allclose(rp["ME"].numpy(), np.asarray(rj["ME"]),
                               rtol=5e-4)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=2e-3)
    torch.testing.assert_close(rp["FE"], rp["A"] - rp["ME"])


def test_rung_solver_hook(problem):
    """run_ladder(rung_solver=K2's solver) against the port's generic
    two-loop ladder over K1's action: on the CPU both run the same plain
    arithmetic, so the records agree exactly."""
    tw, sj, st = problem
    opts = LBFGSOptions(maxiter=100, m=5, pgtol=1e-6, ftol=1e-9,
                        direction="two_loop")
    act, parts = ag.make_action_ag(st, device="cpu", dtype=torch.float64)
    X0 = torch.tensor(random_ensemble_inits(st, 2, seed=3))
    kw = dict(opts=opts, store_paths=False, device="cpu")
    rf0 = 4e-6 * tw["RM"]
    gen = run_ladder(act, parts, X0, np.arange(15, 19), rf0, 1.5, **kw)
    hook = run_ladder(act, parts, X0, np.arange(15, 19), rf0, 1.5,
                      rung_solver=solve.make_rung_solver(st, opts,
                                                         device="cpu"),
                      **kw)
    assert int(hook.niter.sum()) > 0
    for k in ("XP", "A", "ME", "FE", "status", "niter", "nfev", "pgnorm"):
        torch.testing.assert_close(getattr(hook, k), getattr(gen, k),
                                   rtol=0, atol=0)


def test_envelope(problem):
    tw, sj, st = problem
    opts = LBFGSOptions(m=5)
    assert solve.solve_supported(st, 1.0, opts)
    assert solve.solve_supported(st, 1.0, opts, dtype=torch.float64)
    assert solve.ladder_supported(st, 1.0, opts, n_rungs=101)
    assert not solve.solve_supported(st, np.ones((st.N_f, st.D)), opts)
    assert not solve.solve_supported(st, 1.0, LBFGSOptions(m=17))
    assert not solve.ladder_supported(st, 1.0, opts, n_rungs=0)
    lo = np.full(st.n_dof, -10.0)
    assert callable(solve.make_rung_solver(st, opts, lower=lo, device="cpu"))
    with pytest.raises(ValueError):            # bounds not (n_dof,)
        solve.make_rung_solver(st, opts, lower=lo[:-1], device="cpu")
    with pytest.raises(ValueError):
        solve.make_rung_solver(st, LBFGSOptions(m=17), device="cpu")
    s = solve.make_rung_solver(st, opts, device="cpu")
    with pytest.raises(ValueError):            # diagonal rf
        s(torch.zeros(1, st.n_dof), np.ones((st.N_f, st.D)))
    lad = solve.make_ladder_solver(st, opts, 3, device="cpu")
    with pytest.raises(ValueError):            # wrong number of rungs
        lad(torch.zeros(1, st.n_dof), np.ones(2))
    if not torch.cuda.is_available():         # device=None means the card
        for make in (lambda: solve.make_rung_solver(st, opts),
                     lambda: solve.make_ladder_solver(st, opts, 3)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


@pytest.mark.parametrize("extra", [{}, dict(BENCH_SOLVER="fused")])
def test_bench_main_cpu(capsys, extra):
    env = dict(BENCH_NBETA="3", BENCH_MAXITER="20", BENCH_TAIL64="1",
               **extra)
    run = bench.main(device="cpu", env=env)
    out = capsys.readouterr()
    lines = [ln for ln in out.out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline",
                        "platform", "final_A_tail64"}
    assert rec["metric"] == "lorenz96_d20_full_ladder_wall_s_per_init"
    assert rec["unit"] == "s/init" and rec["platform"] == "cpu"
    assert np.isfinite(rec["final_A_tail64"]) and rec["value"] > 0
    assert "total_nfev=" in out.err
    assert tuple(run.res.A.shape) == (1, 3)


@pytest.mark.parametrize("knob,raises", [
    (dict(BENCH_ENGINE="pallas", BENCH_SOLVER="xla"), False),
    (dict(BENCH_PACK="2", BENCH_NINIT="2"), False),
    (dict(BENCH_INNER="lm", BENCH_SOLVER="xla"), False),
    (dict(BENCH_ENGINE="pallas", BENCH_SOLVER="fused"), False),
    (dict(BENCH_ENGINE="pallas", BENCH_PACK="2"), False),
    (dict(BENCH_PACK="2", BENCH_NINIT="2", BENCH_SOLVER="fused"), False),
    (dict(BENCH_ENGINE="pallas"), False),
    (dict(BENCH_INNER="lm"), False),
    (dict(BENCH_INNER="lm", BENCH_SOLVER="fused"), False),
    (dict(BENCH_PACK="2"), False),
    (dict(BENCH_PACK="2", BENCH_NINIT="2", BENCH_SOLVER="xla"), False)])
def test_bench_waiting_paths_raise(knob, raises):
    """A knob raises only where bench.py would take a path the port does
    not have yet (none is left: BENCH_INNER=lm runs opt/lm under xla);
    elsewhere bench.py ignores it, and so does the port.
    BENCH_ENGINE=pallas runs K6 wherever the action is
    evaluated. BENCH_PACK>1 with one init moves a ladder run onto K2 per
    rung, as in bench.py; with several inits it runs the packed solver
    (K8) under ladder and fused."""
    env = dict(BENCH_NBETA="1", BENCH_MAXITER="5", BENCH_TAIL64="0",
               **knob)
    if raises:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            bench.main(device="cpu", env=env)
        return
    from varanneal_tpu_torch import bench as b
    run = b.main(device="cpu", env=env)
    assert np.isfinite(run.out["value"])
    n_init = int(knob.get("BENCH_NINIT", "1"))
    assert tuple(run.res.A.shape) == (n_init, 1)


# ---- the layout planner of K2/K3 (kernels/solve.plan_layout) -------------

V, H, BX, R = solve.VECTORS, solve.HISTORY, solve.BOUNDS, solve.RING_OFF
SMS = 132           # the H100's SMs, given to the planner explicitly here


def _spec_of(st, N_f, D):
    """The CPU problem's spec at another (N_f, D): the predicates read only
    the shape, the model, the rule and the grid's spacing."""
    return dataclasses.replace(st, N_f=N_f, D=D)


@pytest.mark.parametrize("dtype,m,bounded,B,N_f,D,flags", [
    (torch.float32, 5, False, 4, 161, 20, V | H),       # the main shape
    (torch.float32, 5, True, 4, 161, 20, V | H | BX),   # the Quick start
    (torch.float64, 5, False, 4, 161, 20, V),
    (torch.float64, 5, True, 4, 161, 20, V | BX),
    (torch.float32, 5, False, 132, 161, 20, V | H),
    (torch.float32, 5, False, 133, 161, 20, 0),         # above one an SM
    (torch.float32, 5, True, 264, 161, 20, 0),
    (torch.float32, 10, False, 1, 241, 100, 0),         # config #2's size
    (torch.float32, 10, True, 1, 241, 100, BX),      # room the rings left
    (torch.float64, 16, True, 2, 41, 20, V | BX),
    (torch.float32, 16, False, 8, 41, 20, V | H),
    (torch.float32, 16, True, 8, 41, 20, V | H | BX),
    (torch.float64, 1, False, 1, 2, 4, V | H),
    (torch.float32, 5, False, 1024, 161, 400, 0),       # config #5
    (torch.float64, 5, False, 1024, 161, 400, 0),
    (torch.float32, 5, False, 4, 2, 4000, R | V),       # rings off chip
    (torch.float64, 5, True, 4, 3, 1207, R | V | BX)])
def test_plan_layout(dtype, m, bounded, B, N_f, D, flags):
    """The rings on chip where they fit, else in the workspace; then each
    group goes on chip whole, in the order vectors, history, box, where
    it fits in what the groups before it left; within the block's 227 KB;
    the global layout above one member an SM; the workspace holds exactly
    the groups off chip (and the rings under R)."""
    n = N_f * D + 1
    size = torch.finfo(dtype).bits // 8
    lay = solve.plan_layout(D, n, m, dtype, bounded, B, SMS)
    assert lay.flags == flags
    assert lay.smem_bytes <= ag.SMEM_LIMIT
    assert lay == solve.layout_of(flags, D, n, m, dtype, bounded)
    groups = [(V, 5 * n), (H, 2 * m * n + 2 * m)] + (
        [(BX, 2 * n)] if bounded else [])
    ring_off = bool(flags & R)
    assert ring_off == (solve._smem_bytes(D, dtype) > ag.SMEM_LIMIT)
    used = solve._smem_bytes(D, dtype, ring=not ring_off)
    work = ag.ring_elems(D) if ring_off else 0
    for flag, elems in groups:
        if flags & flag:
            used += elems * size
        else:       # it did not fit where it came, or the batch is too big
            assert B > SMS or used + elems * size > ag.SMEM_LIMIT
            work += elems if flag != BX else 0
    assert lay.smem_bytes == used and lay.work_elems == work


def test_launch_layout_given_flags(problem):
    """A launch given the flags takes that layout; the box's flag counts
    only for a bounded launch's workspace and shared memory."""
    tw, sj, st = problem
    c = ag.ag_consts(st, "cpu", torch.float32)
    opts = LBFGSOptions(m=5)
    XP = torch.zeros(3, st.n_dof)
    for flags in (0, V, V | H):
        assert solve.launch_layout(XP, c, opts, False, flags) == \
            solve.layout_of(flags, st.D, st.n_dof, 5, torch.float32, False)
    lay = solve.launch_layout(XP, c, opts, True, V | BX)
    assert lay.work_elems == 2 * 5 * st.n_dof + 10
    assert lay.smem_bytes == (solve._smem_bytes(st.D, torch.float32)
                              + 7 * st.n_dof * 4)


def _csrc(name):
    import pathlib
    return (pathlib.Path(solve.__file__).parent / "csrc" / name).read_text()


def test_constants_match_the_source():
    """The partials count, the history cap, the layout's flags and the
    rings that the wrappers' shared-memory and workspace sizes use are the
    kernels' (csrc/l96_solve.cuh, csrc/l96_ag_block.cuh), read from the
    source."""
    import re
    src = _csrc("l96_solve.cuh") + _csrc("l96_ag_block.cuh")

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kMaxRed") == solve.MAX_RED
    assert const("kMaxM") == solve.MAX_M
    assert (const("kVectorsOnChip"), const("kHistoryOnChip"),
            const("kBoundsOnChip"), const("kRingOffChip")) == (V, H, BX, R)
    assert const("kRingRows") == ag.RING_ROWS
    assert (const("kAgSums"), const("kAgCompSums")) == (ag.AG_SUMS,
                                                       ag.AG_COMP_SUMS)
    # the group's area: two partials areas, alpha and the rings, not N
    warps = ag._THREADS // 32
    assert solve._smem_bytes(4, torch.float32) == (
        2 * const("kMaxRed") * warps + const("kMaxM")
        + const("kRingRows") * 4 * warps) * 4
    assert solve._smem_bytes(20, torch.float64, warps=2) == (
        2 * const("kMaxRed") * 2 + const("kMaxM")
        + const("kRingRows") * 20 * 2) * 8
    assert ag._smem_bytes(400, torch.float32, compensated=True) == (
        const("kAgCompSums") * warps + const("kRingRows") * 400 * warps) * 4


def _parent_solve_ok(spec, opts, dtype):
    """The first port's solve envelope, written out: K1's, scalar rf,
    1 <= m <= 16, maxls >= 1, and K1's residuals and partials, the
    solver's 5 partials a warp and 2 outputs within 227 KB."""
    size = torch.finfo(dtype).bits // 8
    return (1 <= opts.m <= 16 and opts.maxls >= 1
            and ag.ag_supported(spec, 0.0, dtype)
            and ((spec.N_f - 1) * spec.D + 8 * 8 + 2) * size
            <= ag.SMEM_LIMIT)


def _parent_pack_ok(spec, opts, dtype, pack):
    """The first port's K8 envelope on the CPU, written out."""
    from varanneal_tpu_torch.kernels import solve_pack
    G = solve_pack.pack_group(pack)
    size = torch.finfo(dtype).bits // 8
    return (G is not None and 1 <= opts.m <= 8 and opts.maxls >= 1
            and ag.ag_supported(spec, 0.0, dtype)
            and pack * ((spec.N_f - 1) * spec.D + 8 * (G // 32) + 2) * size
            <= ag.SMEM_LIMIT and pack * G <= 512)


def test_envelope_kept(problem):
    """solve_supported, ladder_supported and pack_supported accept every
    shape the first port accepted, over a grid of shapes and at the edge
    of its limit; shared memory no longer bounds them (the evaluation
    keeps rings of 6 rows of D a warp, in the workspace where they do not
    fit), so over the grid they hold wherever m does; and they accept
    BASELINE config #5's shape (N_f = 161, D = 400), which the first port
    refused, in float32 and float64."""
    from varanneal_tpu_torch.kernels import solve_pack
    tw, sj, st = problem
    for dtype in (torch.float32, torch.float64):
        for D in (4, 20, 64, 100, 400, 708, 1000, 4096):
            for N_f in (2, 41, 161, 241, 1001, 3000, 14000):
                sp = _spec_of(st, N_f, D)
                for m in (1, 5, 8, 16, 17):
                    opts = LBFGSOptions(m=m)
                    got = solve.solve_supported(sp, 1.0, opts, dtype)
                    assert got or not _parent_solve_ok(sp, opts, dtype)
                    assert got == (m <= 16)
                    assert solve.ladder_supported(sp, 1.0, opts, dtype,
                                                  n_rungs=3) == got
                for pack in range(1, 10):
                    opts = LBFGSOptions(m=5)
                    got = solve_pack.pack_supported(sp, 1.0, opts, pack,
                                                    dtype, device="cpu")
                    assert got or not _parent_pack_ok(sp, opts, dtype, pack)
                    assert got == (pack <= 8)
        sp5 = _spec_of(st, 161, 400)                # config #5's shape
        opts = LBFGSOptions(m=5)
        assert not _parent_solve_ok(sp5, opts, dtype)
        assert ag.ag_supported(sp5, 0.0, dtype)
        assert ag.ag_supported(sp5, 0.0, dtype, compensated=True)
        assert solve.solve_supported(sp5, 1.0, opts, dtype)
        assert solve.ladder_supported(sp5, 1.0, opts, dtype, n_rungs=17)
        assert solve_pack.pack_supported(sp5, 1.0, opts, 2, dtype,
                                         device="cpu")
        # the edge: the largest residual count the first port accepted,
        # and the next ones
        size = torch.finfo(dtype).bits // 8
        top = ag.SMEM_LIMIT // size - 66          # (N_f - 1) * D at most
        for extra in (0, 4, 8, 12):
            sp = _spec_of(st, (top - top % 4 + extra) // 4 + 1, 4)
            if _parent_solve_ok(sp, LBFGSOptions(m=5), dtype):
                assert solve.solve_supported(sp, 1.0, LBFGSOptions(m=5),
                                             dtype)
