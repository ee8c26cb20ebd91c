"""K8 of the port (varanneal_tpu_torch/kernels/solve_pack.py: the packed
rung solver; the kernel is csrc/pack_kernel.cu, whose plain version runs
here on the CPU) against the JAX package's packed solver
(varanneal_tpu/kernels/solve_pack_pallas.py, interpret mode, as
tests/test_solve_pack.py runs it) and against the port's one-member
solver.

- pack_reference against JAX's make_packed_rung_solver: B=5 at pack 2
  (the batch padded), bounded in tests/test_solve_pack.py's box at pack
  3, and an unbatched call: niter, nfev and status exact, f to 1e-5
  (tests/test_solve_pack.py's bounds; three interpret-mode calls in all);
- pack_reference against solve.solve_reference member by member (f64:
  counts exact, x to 1e-12);
- run_ladder with the packed solver as its rung_solver hook, the
  envelope, and the bench with BENCH_PACK."""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu.api import build_bounds as build_bounds_jax
from varanneal_tpu.kernels import solve_pack_pallas, solve_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax

from varanneal_tpu_torch import bench
from varanneal_tpu_torch.anneal import run_ladder
from varanneal_tpu_torch.kernels import ag, solve, solve_pack
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, spec_from_reference
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.parallel import random_ensemble_inits
from varanneal_tpu_torch.twin import lorenz96_twin

CPU = torch.device("cpu")
SHORT = dict(maxiter=30, m=5, pgtol=1e-4, ftol=1e-6)


@pytest.fixture(autouse=True)
def _interp():
    solve_pallas.set_interpret(True)
    solve_pack_pallas.set_interpret(True)
    yield
    solve_pallas.set_interpret(False)
    solve_pack_pallas.set_interpret(False)


@pytest.fixture(scope="module")
def problem():
    """tests/test_solve_pack.py's problem (D=20, N=41, trapezoid, F
    estimated) in both packages."""
    tw = lorenz96_twin(D=20, N_data=41, n_obs=8)
    sj = build_spec_jax(lorenz96_jax, 20, tw["Y"], tw["t"], tw["Lidx"],
                        tw["RM"], disc="trapezoid", P=np.array([4.0]),
                        pidx=[0])
    st = spec_from_reference(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)},
        lorenz96)
    return tw, sj, st


def _assert_same(rp, rj, bounded_box=None):
    for k in ("niter", "nfev", "status"):
        np.testing.assert_array_equal(getattr(rp, k).numpy(),
                                      np.asarray(getattr(rj, k)))
    np.testing.assert_allclose(rp.f.numpy(), np.asarray(rj.f), rtol=1e-5)
    if bounded_box is not None:
        lo, hi = bounded_box
        x = rp.x.numpy()
        assert np.all(x >= lo - 1e-6) and np.all(x <= hi + 1e-6)


@pytest.mark.parametrize("case", ["padded", "bounded", "unbatched"])
def test_pack_matches_jax(problem, case):
    """tests/test_solve_pack.py's three shapes: a batch of 5 at pack 2,
    a bounded batch of 6 at pack 3, one member unbatched at pack 4."""
    tw, sj, st = problem
    rf = np.float32(4e-6)
    box = None
    kw_j, kw_p = {}, {}
    if case == "bounded":
        lo, hi = build_bounds_jax(sj, [(-6.0, 6.0)] * 20 + [(3.0, 6.0)],
                                  np.float32)
        box = (np.asarray(lo), np.asarray(hi))
        kw_j = dict(lower=lo, upper=hi)
        kw_p = dict(lower=box[0], upper=box[1])
        opts = dict(SHORT, direction="two_loop", bounded_algo="projection")
        B, pack, seed, scale = 6, 3, 9, 3.0
    else:
        opts = dict(SHORT, direction="two_loop")
        B, pack, seed, scale = 5, 2, 7, 1.5
    xp0 = (random_ensemble_inits(st, B, seed=seed, dtype=np.float32)
           * scale)
    if case == "unbatched":         # tests/test_solve_pack.py's draw
        B, pack = 1, 4
        xp0 = np.random.default_rng(0).normal(0, 1, (1, st.n_dof)).astype(
            np.float32)
    sk = solve_pack_pallas.make_packed_rung_solver(sj, OptsJax(**opts),
                                                   pack, **kw_j)
    sp = solve_pack.make_packed_rung_solver(st, LBFGSOptions(**opts), pack,
                                            device=CPU, **kw_p)
    if case == "unbatched":
        x1 = xp0[0]
        rj = sk(jnp.asarray(x1), rf)
        rp = sp(torch.tensor(x1), float(rf))
        assert tuple(rp.x.shape) == (st.n_dof,) and rp.niter.ndim == 0
        rp = type(rp)(*(v[None] for v in rp))
        rj = type(rj)(*(np.asarray(v)[None] for v in rj))
    else:
        rj = jax.jit(jax.vmap(lambda z: sk(z, rf)))(jnp.asarray(xp0))
        rp = sp(torch.tensor(xp0), float(rf))
        assert tuple(rp.x.shape) == (B, st.n_dof)
    assert int(rp.niter.sum()) > 0
    _assert_same(rp, rj, box)


@pytest.mark.parametrize("B,pack", [(5, 2), (6, 3), (4, 4)])
def test_pack_reference_memberwise(problem, B, pack):
    """The packed plain solve is the one-member solve of each member: f64,
    counts exact, x and f to 1e-12 (a member's arithmetic does not depend
    on the batch it rides in)."""
    tw, sj, st = problem
    c = ag.ag_consts(st, CPU, torch.float64)
    rng = np.random.default_rng(B)
    X0 = torch.tensor(random_ensemble_inits(st, B, seed=pack)
                      + rng.normal(0, 0.5, (B, st.n_dof)))
    opts = LBFGSOptions(**SHORT)
    rf = 4e-6 * float(tw["RM"]) * 1.5 ** 30
    rk = solve_pack.pack_reference(X0, rf, c, opts, pack)
    for b in range(B):
        r1 = solve.solve_reference(X0[b:b + 1], rf, c, opts)
        for k in ("niter", "nfev", "status"):
            assert int(getattr(rk, k)[b]) == int(getattr(r1, k)[0])
        torch.testing.assert_close(rk.x[b], r1.x[0], rtol=0, atol=1e-12)
        torch.testing.assert_close(rk.f[b], r1.f[0], rtol=1e-12, atol=0)
    assert int(rk.niter.sum()) > 0


def test_ladder_hook(problem):
    """run_ladder(rung_solver=the packed solver) over 3 rungs, B=3 at pack
    2: on the CPU both run the plain solve, so the records equal those of
    the one-member solver's hook exactly."""
    tw, sj, st = problem
    opts = LBFGSOptions(maxiter=60, m=5, pgtol=1e-6, ftol=1e-9)
    act, parts = ag.make_action_ag(st, device=CPU, dtype=torch.float64)
    X0 = torch.tensor(random_ensemble_inits(st, 3, seed=3))
    kw = dict(opts=opts, store_paths=False, device=CPU)
    rf0 = 4e-6 * tw["RM"]
    runs = [run_ladder(act, parts, X0, np.arange(28, 31), rf0, 1.5,
                       rung_solver=s, **kw)
            for s in (solve_pack.make_packed_rung_solver(st, opts, 2,
                                                         device=CPU),
                      solve.make_rung_solver(st, opts, device=CPU))]
    assert int(runs[0].niter.sum()) > 0
    for k in ("XP", "A", "ME", "FE", "status", "niter", "nfev", "pgnorm"):
        torch.testing.assert_close(getattr(runs[0], k),
                                   getattr(runs[1], k), rtol=0, atol=0)


def test_envelope(problem):
    tw, sj, st = problem
    opts = LBFGSOptions(m=5)
    assert [solve_pack.pack_group(k) for k in range(10)] == [
        None, 256, 256, 64, 64, 32, 32, 32, 32, None]
    for k in range(1, 9):
        assert solve_pack.pack_supported(st, 1.0, opts, k, device=CPU)
        assert solve_pack.pack_supported(st, 1.0, opts, k, torch.float64,
                                         bounded=True, device=CPU)
    assert not solve_pack.pack_supported(st, 1.0, opts, 0, device=CPU)
    assert not solve_pack.pack_supported(st, 1.0, opts, 9, device=CPU)
    assert not solve_pack.pack_supported(st, 1.0, LBFGSOptions(m=9), 2,
                                         device=CPU)
    assert not solve_pack.pack_supported(
        st, np.ones((st.N_f - 1, st.D)), opts, 2, device=CPU)
    assert not solve_pack.pack_supported(
        dataclasses.replace(st, disc="euler"), 1.0, opts, 2, device=CPU)
    # shared memory: eight f64 one-warp groups' rings at D = 700 pass 227
    # KB, so they go to the members' workspaces (the first port refused
    # every pack whose (N_f - 1) * D residuals passed it); a pack of one
    # takes K2's plan; past the 32-bit index range the pack is refused
    tw2 = lorenz96_twin(D=700, N_data=9, n_obs=8)
    big = build_spec(lorenz96, 700, tw2["Y"], tw2["t"], tw2["Lidx"],
                     tw2["RM"], P=np.array([4.0]), pidx=[0])
    f64 = torch.float64
    assert 8 * solve._smem_bytes(700, f64, 1) > ag.SMEM_LIMIT
    lay = solve_pack.pack_layout(big, f64, 8, 5, 8)
    assert lay.flags == solve.RING_OFF
    assert lay.smem_bytes == 8 * solve._smem_bytes(700, f64, 1, ring=False)
    assert lay.smem_bytes <= ag.SMEM_LIMIT
    assert lay.work_elems == (15 * big.n_dof + 10 + ag.ring_elems(700, 1))
    assert solve_pack.pack_layout(big, f64, 1, 5, 1) == solve.plan_layout(
        700, big.n_dof, 5, f64, False, 1, 132)
    for k in (1, 4, 8):
        assert solve_pack.pack_supported(big, 1.0, opts, k, f64, device=CPU)
    huge = dataclasses.replace(st, N_f=2 ** 22, D=512)
    assert not solve_pack.pack_supported(huge, 1.0, opts, 2, device=CPU)
    with pytest.raises(ValueError):
        solve_pack.make_packed_rung_solver(st, opts, 9, device=CPU)
    s = solve_pack.make_packed_rung_solver(st, opts, 2, device=CPU)
    with pytest.raises(ValueError):            # diagonal rf
        s(torch.zeros(2, st.n_dof), np.ones((st.N_f - 1, st.D)))
    if not torch.cuda.is_available():         # device=None means the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve_pack.make_packed_rung_solver(st, opts, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve_pack.pack_supported(st, 1.0, opts, 2)


def test_block_groups():
    """The group rule: packs of 1–2 run one member a block of 256 threads
    (K2's arrangement), packs of 3–4 groups of 64 and packs of 5–8 groups
    of 32 (one warp a member), so that no block has more than 256 threads
    and every thread may keep 255 registers (65,536 / 256), as K2's do.
    Packs of 1–2 take solve.plan_layout's plan itself (vectors, history
    and box in shared memory at up to one member an SM, the global layout
    above); packs of 3–8 keep every vector in the workspace and their
    groups' areas in shared memory, the block's groups' times one
    member's."""
    assert [solve_pack.pack_group(k) for k in range(1, 9)] == [
        256, 256, 64, 64, 32, 32, 32, 32]
    assert [solve_pack.block_groups(k) for k in range(1, 9)] == [
        1, 1, 3, 4, 5, 6, 7, 8]
    assert solve_pack.PACK_MAX_THREADS * 255 <= 65536
    for k in range(1, 9):
        assert (solve_pack.block_groups(k) * solve_pack.pack_group(k)
                <= solve_pack.PACK_MAX_THREADS)
    tw = lorenz96_twin(D=20, N_data=161, n_obs=8)
    main = build_spec(lorenz96, 20, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                      P=np.array([4.0]), pidx=[0])
    n = main.n_dof
    for dt in (torch.float32, torch.float64):
        for bounded in (False, True):
            for B in (4, 132, 133, 264):
                for k in (1, 2):
                    assert solve_pack.pack_layout(
                        main, dt, k, 5, B, bounded, 132) == solve.plan_layout(
                            20, n, 5, dt, bounded, B, 132)
            for k in range(3, 9):
                lay = solve_pack.pack_layout(main, dt, k, 5, 264, bounded)
                G = solve_pack.pack_group(k)
                assert lay == solve.Layout(
                    0, k * solve._smem_bytes(20, dt, G // 32),
                    15 * n + 10)
    # the main shape in f32: K2's all-on-chip layout at up to one member an
    # SM (~196 KB a block, no workspace), the global layout above it
    lay = solve_pack.pack_layout(main, torch.float32, 2, 5, 4)
    assert lay.flags == solve.VECTORS | solve.HISTORY
    assert lay.work_elems == 0 and lay.smem_bytes <= ag.SMEM_LIMIT
    assert solve_pack.pack_layout(main, torch.float32, 2, 5, 264).flags == 0
    tw = lorenz96_twin(D=400, N_data=9, n_obs=8)
    big = build_spec(lorenz96, 400, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                     P=np.array([4.0]), pidx=[0])
    for dt in (torch.float32, torch.float64):
        assert solve_pack.pack_layout(big, dt, 3, 5, 6).smem_bytes == (
            3 * solve._smem_bytes(400, dt, 2))
        assert solve_pack.pack_layout(big, dt, 8, 5, 8).smem_bytes == (
            8 * solve._smem_bytes(400, dt, 1))


def test_bench_pack(capsys):
    """BENCH_PACK=2 with 3 inits takes the packed solver (the plain
    version here) under ladder and fused, and matches the K2 path's
    records; BENCH_PACK=9 prints bench.py's note and takes K2."""
    env = dict(BENCH_NBETA="2", BENCH_MAXITER="10", BENCH_TAIL64="0",
               BENCH_NINIT="3")
    runs = {}
    for label, extra in (("pack", dict(BENCH_PACK="2")),
                         ("fused", dict(BENCH_SOLVER="fused")),
                         ("pack9", dict(BENCH_PACK="9"))):
        runs[label] = bench.main(device=CPU, env=dict(env, **extra))
        out = capsys.readouterr()
        rec = json.loads(out.out.strip().splitlines()[-1])
        assert rec["platform"] == "cpu"
        assert ("# BENCH_PACK unsupported here; k=1 fused" in out.err) is (
            label == "pack9")
        assert set(runs[label].launches) >= {"rung", "ladder", "pack"}
    for label in ("pack", "pack9"):
        for k in ("A", "niter", "nfev", "status"):
            torch.testing.assert_close(getattr(runs[label].res, k),
                                       getattr(runs["fused"].res, k),
                                       rtol=0, atol=0)
