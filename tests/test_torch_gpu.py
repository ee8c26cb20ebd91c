"""K1, K4, K2, K3, K7a, K7b, K6, K5 and K8 on the card. K1, the nvcc-built
CUDA kernel (kernels/csrc/ag_kernel.cu), against its plain PyTorch version at the
main path's shape (Lorenz-96 D=20, N=161, L=8, B=4), f64 to 1e-12 and
f32 to 2e-5 relative (the card sums in another order than the plain
version); at BASELINE config #5's width (D=400, K4 with it), and at the
first D whose rings of rows leave shared memory for a workspace; its
launch count, its autograd Function, and a short f64 ladder through it.
K4, the compensated entry of the same source: its
combined value within 2e-6 (f32; 1e-12 in f64) of the plain version's,
its gradient bit-equal to K1's. K2 and K3 (kernels/csrc/solve_kernel.cu) against
their plain versions in f64: the same niter, nfev and status on short
solves, the same actions over a short ladder, and bit-identical repeats;
K2's bounded branch likewise, and feasible; both bit-identical in every
layout of a member's vectors and of the evaluation's rings (shared or
global memory). K7a and K7b
(kernels/csrc/dir_kernel.cu) against their plain versions at the main
shape (n = 3,221, m = 5) at every (head, hlen), within the bounds of
tests/test_dir_pallas.py, with repeats bit-identical and an ended member
left untouched. K6 (kernels/csrc/fe_kernel.cu), its kernels against
their plain versions at configs #1, #2 and #5's shapes (f64 1e-12, f32
2e-5), the fused Hermite–Simpson launch against its plain version and
against the forward and backward (Lorenz-96 and NaKL), engine='pallas'
through autograd on the card and its value_and_grad, one fused launch a
call, and the fused one-step launch against its plain version and
against the forward (Lorenz-96 and NaKL, the three rules), and the
four kernels on Colpitts and Lorenz-63 against their plain versions. K5
(kernels/csrc/agt_kernel.cu) against its plain version over the three
one-step rules × scalar and (N_f-1, D) rf at D = 20, 40 and 64 and at
D = 64 with N = 1,001 (f64 1e-12, f32 2e-5), and K8
(kernels/csrc/pack_kernel.cu) against K2, bit for bit at pack 2, and
against its plain version at pack 3; K1 and K4's rules' entries
(kernels/csrc/ag_rules_kernel.cu) under the four rules × scalar and
(N_f-1, D) rf against their plain version, and K2 under
Hermite–Simpson with an (N_f-1, D) rf (kernels/csrc/solve_rules_f32.cu)
against the plain solve; K1 and K4 on NaKL, Colpitts and Lorenz-63
(kernels/csrc/ag_models_kernel.cu) under the four rules × both rf kinds
against their plain version, and K2/K3 on them
(kernels/csrc/solve_models_*.cu) against the plain solve in f64. Run on
a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

(--noconftest: tests/conftest.py sets up JAX, which that machine need not
have; this file imports no JAX.)
Without a card each test skips inside the test (the decision is never
made at import time, so every pytest-xdist worker collects the same
tests)."""

import dataclasses

import numpy as np
import pytest
import torch

from varanneal_tpu_torch.anneal.ladder import rung_rf
from varanneal_tpu_torch.api import build_bounds
from varanneal_tpu_torch.kernels import ag, fe, solve, solve_pack
from varanneal_tpu_torch.kernels import dir as kdir
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, make_action, pack
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.parallel import make_ensemble_ladder
from varanneal_tpu_torch.twin import lorenz96_twin

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _main_spec():
    tw = lorenz96_twin(D=20, N_data=161, n_obs=8)
    spec = build_spec(lorenz96, 20, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                      disc="trapezoid", P=np.array([4.0]), pidx=[0])
    return spec, tw


def _draw(spec, tw, B, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        X = rng.normal(2.0, 2.0, (spec.N_f, spec.D))
        rows = np.arange(spec.N_data) * spec.obs_stride
        X[np.ix_(rows, np.asarray(spec.Lidx))] = tw["Y"] + rng.normal(
            0, 0.3, tw["Y"].shape)
        out.append(pack(spec, X, np.array([4.0 + rng.normal()])))
    return np.stack(out)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_kernel_matches_plain(cuda, dtype, tol):
    spec, tw = _main_spec()
    c = ag.ag_consts(spec, cuda, dtype)
    Z = torch.tensor(_draw(spec, tw, 4), dtype=dtype, device=cuda)
    for beta in (0, 50, 100):
        rf = float(4e-6 * tw["RM"] * 1.5 ** beta)
        n0 = ag.LAUNCHES
        A, G = ag.ag_kernel(Z, rf, c)
        torch.cuda.synchronize()
        assert ag.LAUNCHES == n0 + 1
        A_r, G_r = ag.ag_reference(Z, rf, c)
        assert torch.all(torch.abs(A - A_r) <= tol * torch.abs(A_r))
        scale = torch.amax(torch.abs(G_r), dim=1, keepdim=True)
        assert torch.all(torch.abs(G - G_r) <= tol * scale)
        A2, G2 = ag.ag_kernel(Z, rf, c)           # no atomics: repeatable
        assert torch.equal(A, A2) and torch.equal(G, G2)


def _wide_spec(D, N_data, n_obs):
    tw = lorenz96_twin(D=D, N_data=N_data, n_obs=n_obs, spin=300)
    spec = build_spec(lorenz96, D, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                      disc="trapezoid", P=np.array([4.0]), pidx=[0])
    return spec, tw


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_kernel_matches_plain_d400(cuda, dtype, tol):
    """K1 and K4 at BASELINE config #5's width (D = 400, N = 161, 160
    observed; the wide walk) against the plain version, K4's gradient
    bit-equal to K1's."""
    spec, tw = _wide_spec(400, 161, 160)
    c = ag.ag_consts(spec, cuda, dtype)
    Z = torch.tensor(_draw(spec, tw, 4), dtype=dtype, device=cuda)
    for beta in (0, 25, 50):
        rf = float(4e-6 * tw["RM"] * 1.5 ** beta)
        A, G = ag.ag_kernel(Z, rf, c)
        A4, G4, _ = ag.ag_kernel(Z, rf, c, compensated=True)
        A_r, G_r = ag.ag_reference(Z, rf, c)
        assert torch.all(torch.abs(A - A_r) <= tol * torch.abs(A_r))
        scale = torch.amax(torch.abs(G_r), dim=1, keepdim=True)
        assert torch.all(torch.abs(G - G_r) <= tol * scale)
        assert torch.equal(G, G4) and torch.equal(A, A4)


@pytest.mark.parametrize("dtype,D", [(torch.float64, 605),
                                     (torch.float32, 1211)])
def test_envelope_edge(cuda, dtype, D):
    """The first D whose rings do not fit in shared memory: K1 takes them
    in a workspace and matches its plain version (f64 1e-12, f32 2e-5);
    one D less keeps them on chip."""
    assert not ag.ring_on_chip(D, dtype) and ag.ring_on_chip(D - 1, dtype)
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    spec, tw = _wide_spec(D, 5, 40)
    c = ag.ag_consts(spec, cuda, dtype)
    Z = torch.tensor(_draw(spec, tw, 3), dtype=dtype, device=cuda)
    A, G = ag.ag_kernel(Z, 37.5, c)
    A_r, G_r = ag.ag_reference(Z, 37.5, c)
    assert torch.all(torch.abs(A - A_r) <= tol * torch.abs(A_r))
    scale = torch.amax(torch.abs(G_r), dim=1, keepdim=True)
    assert torch.all(torch.abs(G - G_r) <= tol * scale)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-6)])
def test_comp_kernel_matches_plain(cuda, dtype, tol):
    """K4: the combined value (float64 combine) within ``tol`` relative of
    its plain version's, the gradient bit-equal to K1's on the same
    input, one count per launch, repeats bit-identical."""
    spec, tw = _main_spec()
    c = ag.ag_consts(spec, cuda, dtype, compensated=True)
    Z = torch.tensor(_draw(spec, tw, 4), dtype=dtype, device=cuda)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for beta in (0, 50, 100):
            rf = float(4e-6 * tw["RM"] * 1.5 ** beta)
            n0 = ag.COMP_LAUNCHES
            A, G, C = ag.ag_kernel(Z, rf, c, compensated=True)
            torch.cuda.synchronize()
            assert ag.COMP_LAUNCHES == n0 + 1
            A1, G1 = ag.ag_kernel(Z, rf, c)
            assert torch.equal(A, A1) and torch.equal(G, G1)
            A_r, _, C_r = ag.ag_reference(Z, rf, c, compensated=True)
            v, v_r = ag.combine(C, rf, c), ag.combine(C_r, rf, c)
            assert v.dtype == torch.float64
            assert torch.all(torch.abs(v - v_r) <= tol * torch.abs(v_r))
            A2, G2, C2 = ag.ag_kernel(Z, rf, c, compensated=True)
            assert torch.equal(C, C2) and torch.equal(G, G2)
            assert torch.all(C[:, 4:] == 0)
    finally:
        torch.set_default_dtype(old)


def test_autograd_and_dispatch(cuda):
    spec, tw = _main_spec()
    action, _ = ag.make_action_ag(spec, device=cuda, dtype=torch.float64)
    Z = torch.tensor(_draw(spec, tw, 2), device=cuda)
    A, G = action.value_and_grad(Z, 3.0)
    z = Z.clone().requires_grad_(True)
    (2.0 * action(z, 3.0).sum()).backward()
    torch.testing.assert_close(z.grad, 2.0 * G, rtol=1e-15, atol=0)
    with pytest.raises(ValueError):
        action.value_and_grad(Z.float(), 3.0)     # wrong dtype: raises


def test_f64_ladder_kernel_vs_plain(cuda):
    """Every rung solved to pgtol (ftol off) from near the truth at
    rf0 = RM, where the minima are insensitive to rounding; an ftol stop
    or a flat low-rf rung would move by more than 1e-8 between any two
    f64 implementations."""
    spec, tw = _main_spec()
    act, parts = ag.make_action_ag(spec, device=cuda, dtype=torch.float64)
    c = act.consts

    def plain(XP, rf):
        return ag.ag_reference(XP, rf, c)[0]

    plain.value_and_grad = lambda XP, rf: ag.ag_reference(XP, rf, c)
    opts = LBFGSOptions(m=5, maxiter=3000, maxls=20, pgtol=1e-8, ftol=0.0)
    rng = np.random.default_rng(1)
    xp0 = torch.tensor(np.stack([
        pack(spec, tw["traj"] + 0.3 * rng.normal(size=tw["traj"].shape),
             np.array([tw["F"] + 0.5 * rng.normal()])) for _ in range(2)]),
        device=cuda)
    runs = [make_ensemble_ladder(a, parts, np.arange(4), float(tw["RM"]),
                                 1.5, opts=opts, device=cuda)(xp0)
            for a in (act, plain)]
    both = (runs[0].status <= 1) & (runs[1].status <= 1)
    assert both.float().mean() >= 0.8
    rel = torch.abs(runs[0].A - runs[1].A) / torch.abs(runs[1].A)
    assert float(rel[both].max()) <= 1e-8


def test_rung_solve_kernel_matches_plain(cuda):
    """K2 in f64 on short solves (maxiter 30) at three rungs of the bench's
    ladder: identical niter, nfev and status per member, x to 1e-8
    relative; a second launch gives the same bits."""
    spec, tw = _main_spec()
    c = ag.ag_consts(spec, cuda, torch.float64)
    Z = torch.tensor(_draw(spec, tw, 4), device=cuda)
    opts = LBFGSOptions(maxiter=30, m=5, pgtol=1e-4, ftol=1e-6)
    for beta in (0, 50, 100):
        rf = rung_rf(4e-6 * tw["RM"], 1.5, beta, torch.float64)
        n0 = solve.RUNG_LAUNCHES
        rk = solve.solve_kernel(Z, rf, c, opts)
        torch.cuda.synchronize()
        assert solve.RUNG_LAUNCHES == n0 + 1
        rp = solve.solve_reference(Z, rf, c, opts)
        for k in ("niter", "nfev", "status"):
            assert torch.equal(getattr(rk, k), getattr(rp, k)), k
        scale = torch.amax(torch.abs(rp.x), dim=1, keepdim=True)
        assert torch.all(torch.abs(rk.x - rp.x) <= 1e-8 * scale)
        r2 = solve.solve_kernel(Z, rf, c, opts)
        assert all(torch.equal(u, v) for u, v in zip(rk, r2))


def test_ladder_kernel_matches_plain(cuda):
    """K3 in f64 over 4 rungs from near the truth at rf0 = RM, every rung
    solved to pgtol 1e-8 (ftol off): the action at every mutually
    converged rung to 1e-8 relative against the plain ladder, and a
    repeated launch bit-identical."""
    spec, tw = _main_spec()
    c = ag.ag_consts(spec, cuda, torch.float64)
    opts = LBFGSOptions(m=5, maxiter=3000, maxls=20, pgtol=1e-8, ftol=0.0)
    rng = np.random.default_rng(1)
    xp0 = torch.tensor(np.stack([
        pack(spec, tw["traj"] + 0.3 * rng.normal(size=tw["traj"].shape),
             np.array([tw["F"] + 0.5 * rng.normal()])) for _ in range(2)]),
        device=cuda)
    rfs = np.array([rung_rf(float(tw["RM"]), 1.5, b, torch.float64)
                    for b in range(4)])
    lad = solve.make_ladder_solver(spec, opts, 4, device=cuda)
    n0 = solve.LADDER_LAUNCHES
    xk, rk = lad(xp0, rfs)
    torch.cuda.synchronize()
    assert solve.LADDER_LAUNCHES == n0 + 1
    xp, rp = solve.ladder_reference(xp0, rfs, c, opts)
    both = (rk["status"] <= 1) & (rp["status"] <= 1)
    assert both.float().mean() >= 0.8
    rel = torch.abs(rk["A"] - rp["A"]) / torch.abs(rp["A"])
    assert float(rel[both].max()) <= 1e-8
    xk2, rk2 = lad(xp0, rfs)
    assert torch.equal(xk, xk2)
    assert all(torch.equal(rk[k], rk2[k]) for k in rk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_layouts_bit_identical(cuda, dtype):
    """K2 (unbounded and in a box) and K3 give the same bits in every
    layout the kernels take (a member's vectors, history and box in
    shared memory or in the global workspace), the planner's included;
    the kernel's shared memory is the planner's, and a layout that does
    not fit is refused, not run."""
    spec, tw = _main_spec()
    c = ag.ag_consts(spec, cuda, dtype)
    Z = torch.tensor(_draw(spec, tw, 3), dtype=dtype, device=cuda)
    opts = LBFGSOptions(maxiter=20, m=5, pgtol=1e-4, ftol=1e-6)
    lo, hi = (torch.tensor(b, dtype=dtype, device=cuda) for b in build_bounds(
        spec, [(-6.0, 6.0)] * 20 + [(3.0, 6.0)], np.float64))
    rf = rung_rf(4e-6 * tw["RM"], 1.5, 50, dtype)
    rfs = torch.tensor([rf, 2 * rf], dtype=dtype, device=cuda)
    V, H, BX, R = solve.VECTORS, solve.HISTORY, solve.BOUNDS, solve.RING_OFF
    lib = solve._lib()
    runs = {}
    for flags in (None, 0, V, H, V | H, V | H | BX, V | BX, R, V | H | R):
        lay = solve.layout_of(flags or 0, spec.D, spec.n_dof, 5, dtype, True)
        assert lib.va_l96_solve_smem(spec.D, spec.n_dof, 5, lay.flags,
                                     int(dtype == torch.float64)
                                     ) == lay.smem_bytes
        if lay.smem_bytes > ag.SMEM_LIMIT:
            with pytest.raises(RuntimeError, match="launch failed"):
                solve.solve_kernel(Z, rf, c, opts, lo, hi, _layout=flags)
            continue
        out = [*solve.solve_kernel(Z, rf, c, opts, lo, hi, _layout=flags)]
        if flags is None or not flags & BX:
            out += [*solve.solve_kernel(Z, rf, c, opts, _layout=flags)]
            x, r = solve.ladder_kernel(Z, rfs, c, opts, _layout=flags)
            out += [x] + [r[k] for k in sorted(r)]
        runs[flags] = out
    torch.cuda.synchronize()
    for flags, out in runs.items():
        ref = runs[0] if flags is None or not flags & BX else runs[0][:7]
        assert all(torch.equal(u, v) for u, v in zip(out, ref)), flags


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_layouts_bit_identical_wide_walk(cuda, dtype):
    """The same at D = 40 (N_data = 9), where the evaluation takes the
    wide walk with its ring of rows: K2 and K3 give the same bits with x
    in the workspace (staged into the ring) or in shared memory, and with
    the ring on chip or in the workspace past the off-chip groups."""
    spec, tw = _wide_spec(40, 9, 16)
    c = ag.ag_consts(spec, cuda, dtype)
    Z = torch.tensor(_draw(spec, tw, 3), dtype=dtype, device=cuda)
    opts = LBFGSOptions(maxiter=20, m=5, pgtol=1e-4, ftol=1e-6)
    rf = rung_rf(4e-6 * tw["RM"], 1.5, 25, dtype)
    rfs = torch.tensor([rf, 2 * rf], dtype=dtype, device=cuda)
    V, H, R = solve.VECTORS, solve.HISTORY, solve.RING_OFF
    runs = {}
    for flags in (None, 0, V, V | H, R, V | R, V | H | R):
        lay = solve.layout_of(flags or 0, spec.D, spec.n_dof, 5, dtype,
                              False)
        assert lay.smem_bytes <= ag.SMEM_LIMIT
        out = [*solve.solve_kernel(Z, rf, c, opts, _layout=flags)]
        x, r = solve.ladder_kernel(Z, rfs, c, opts, _layout=flags)
        runs[flags] = out + [x] + [r[k] for k in sorted(r)]
    torch.cuda.synchronize()
    assert int(runs[0][3].sum()) > 0                 # niter: it iterated
    for flags, out in runs.items():
        assert all(torch.equal(u, v) for u, v in zip(out, runs[0])), flags


def test_refused_launch_leaves_no_error(cuda):
    """A launch refused for its shared memory (K2 and K3 in f64 with the
    vectors and the history on chip at D = 20) raises, and the next launch,
    one that needs no opt-in, runs: the refusal's error is not reported
    again by it."""
    spec, tw = _main_spec()
    c = ag.ag_consts(spec, cuda, torch.float64)
    Z = torch.tensor(_draw(spec, tw, 2), device=cuda)
    opts = LBFGSOptions(maxiter=5, m=5, pgtol=1e-4, ftol=1e-6)
    rf = rung_rf(4e-6 * tw["RM"], 1.5, 25, torch.float64)
    rfs = torch.tensor([rf], dtype=torch.float64, device=cuda)
    VH = solve.VECTORS | solve.HISTORY
    assert solve.layout_of(VH, spec.D, spec.n_dof, 5, torch.float64,
                           False).smem_bytes > ag.SMEM_LIMIT
    with pytest.raises(RuntimeError, match="launch failed"):
        solve.solve_kernel(Z, rf, c, opts, _layout=VH)
    r = solve.solve_kernel(Z, rf, c, opts, _layout=0)
    with pytest.raises(RuntimeError, match="launch failed"):
        solve.ladder_kernel(Z, rfs, c, opts, _layout=VH)
    x, _ = solve.ladder_kernel(Z, rfs, c, opts, _layout=0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(r.f).all()) and bool(torch.isfinite(x).all())


def test_bounded_rung_solve_kernel_matches_plain(cuda):
    """K2's bounded branch in f64 on short solves (maxiter 30) in the box
    states (-6, 6), F (3, 6) at three rungs: identical niter, nfev and
    status, x to 1e-8 relative, every x feasible and some component at a
    bound; a second launch gives the same bits."""
    spec, tw = _main_spec()
    c = ag.ag_consts(spec, cuda, torch.float64)
    Z = torch.tensor(_draw(spec, tw, 4), device=cuda)
    lo, hi = (torch.tensor(b, device=cuda) for b in build_bounds(
        spec, [(-6.0, 6.0)] * 20 + [(3.0, 6.0)], np.float64))
    opts = LBFGSOptions(maxiter=30, m=5, pgtol=1e-4, ftol=1e-6)
    for beta in (0, 50, 100):
        rf = rung_rf(4e-6 * tw["RM"], 1.5, beta, torch.float64)
        rk = solve.solve_kernel(Z, rf, c, opts, lo, hi)
        torch.cuda.synchronize()
        rp = solve.solve_reference(Z, rf, c, opts, lo, hi)
        for k in ("niter", "nfev", "status"):
            assert torch.equal(getattr(rk, k), getattr(rp, k)), k
        scale = torch.amax(torch.abs(rp.x), dim=1, keepdim=True)
        assert torch.all(torch.abs(rk.x - rp.x) <= 1e-8 * scale)
        assert bool(((rk.x >= lo) & (rk.x <= hi)).all())
        assert bool(((rk.x == lo) | (rk.x == hi)).any())
        r2 = solve.solve_kernel(Z, rf, c, opts, lo, hi)
        assert all(torch.equal(u, v) for u, v in zip(rk, r2))


def _histories(rng, m, pairs, n, dev):
    H = np.zeros((len(pairs), 2 * m, n), np.float32)
    for b, (head, hlen) in enumerate(pairs):
        for j in range(hlen):
            slot = (head - hlen + j) % m
            s = rng.normal(size=n)
            H[b, slot], H[b, m + slot] = s, rng.normal(size=n) * 0.3 + s
    return torch.tensor(H, device=dev)


def _dir_close(d_k, d_p, d_64):
    """Each member's direction within 2e-5 of its max|d|
    (tests/test_dir_pallas.py's bound for the step kernel) or, where
    larger, twice the plain f32 version's own error against f64 on the
    same inputs, capped at 7.2e-5: at n = 3,221 and m = 7 that error
    reaches 3.5e-5 of max|d|, and tests/test_torch_dir.py holds it under
    3.6e-5 over 40 seeded batches on the CPU."""
    s_p = torch.amax(torch.abs(d_p), dim=1).double()
    e_k = torch.amax(torch.abs(d_k - d_p), dim=1).double() / s_p
    w = torch.amax(torch.abs(d_p.double() - d_64), dim=1) / torch.amax(
        torch.abs(d_64), dim=1)
    return bool(torch.all(e_k <= torch.clamp(2.0 * w, min=2e-5,
                                             max=7.2e-5)))


@pytest.mark.parametrize("m,n,B", [
    (5, 3221, 4), (7, 3221, 4), (5, 37, 4), (7, 37, 4), (5, 32768, 4),
    (7, 32768, 4), (5, 3221, 1), (7, 3221, 133)])
def test_dir_kernels_match_plain(cuda, m, n, B):
    """K7a and K7b, one cluster of blocks a member (kernels/dir.py's
    cluster_plan: 1 block at n = 37 and at B = 133, 4 at the main shape,
    8 at n = 32,768, where at m = 7 one history row stays off chip), for
    every (head, hlen) of an m-history (a subset at n = 32,768), B members
    a launch, inputs from a seeded NumPy generator: the direction as
    _dir_close says, history rows and max|g| rtol 1e-6, Σ|g| rtol 1e-5,
    good/head/hlen exact; repeats bit-identical; every member with run = 0
    left as it was; a block's shared memory as the plan counts it."""
    rng = np.random.default_rng(m + n + B)
    pairs = [(h, l) for h in range(m) for l in range(m + 1)]
    if n > 4096:
        pairs = pairs[::5]
    lib = kdir._lib()
    batches = range(0, len(pairs), B) if B < len(pairs) else [0]
    for i in batches:
        batch = [pairs[(i + j) % len(pairs)] for j in range(B)]
        H = _histories(rng, m, batch, n, cuda)
        for step in (False, True):
            p = kdir.launch_plan(H, step)
            assert lib.va_dir_smem(m, int(step), p.width,
                                   p.rows) == p.smem_bytes
        hd = torch.tensor([q[0] for q in batch], dtype=torch.int32,
                          device=cuda)
        hl = torch.tensor([q[1] for q in batch], dtype=torch.int32,
                          device=cuda)
        g = torch.tensor(rng.normal(size=(B, n)), dtype=torch.float32,
                         device=cuda)
        d_k = kdir.compact_dir_kernel(g, H, hd, hl)
        torch.cuda.synchronize()
        d_p = kdir.compact_dir_reference(g, H, hd, hl)
        d_64 = kdir.compact_dir_reference(g.double(), H.double(), hd, hl)
        assert _dir_close(d_k, d_p, d_64)
        assert torch.equal(d_k, kdir.compact_dir_kernel(g, H, hd, hl))

        x_old, g_old, dx, dg = (
            torch.tensor(rng.normal(size=(B, n)), dtype=torch.float32,
                         device=cuda) for _ in range(4))
        x_new = x_old + 0.1 * dx
        g_new = g_old + 0.1 * dg
        idx = torch.arange(i, i + B, device=cuda)
        ls_ok = idx % 4 != 1
        run = idx % 4 != 2
        args = (x_old, x_new, g_old, g_new)
        Hk, hk, lk = H.clone(), hd.clone(), hl.clone()
        Hp, hp, lp = H.clone(), hd.clone(), hl.clone()
        d_k, sc_k = kdir.fused_step_kernel(Hk, *args, hk, lk, ls_ok, run)
        torch.cuda.synchronize()
        d_p, sc_p = kdir.fused_step_reference(Hp, *args, hp, lp, ls_ok,
                                              run)
        d_64, _ = kdir.fused_step_reference(
            H.double(), *(a.double() for a in args), hd.clone(), hl.clone(),
            ls_ok, run)
        assert torch.equal(hk, hp) and torch.equal(lk, lp)
        assert torch.equal(sc_k[:, [0, 3, 4]], sc_p[:, [0, 3, 4]])
        assert torch.all(torch.abs(Hk - Hp) <= 1e-6 * torch.abs(Hp))
        torch.testing.assert_close(sc_k[:, 1], sc_p[:, 1], rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(sc_k[:, 2], sc_p[:, 2], rtol=1e-5,
                                   atol=0)
        if run.any():
            assert _dir_close(d_k[run], d_p[run], d_64[run])
        assert torch.equal(d_k[~run], d_p[~run])
        ended = ~run
        assert torch.equal(Hk[ended], H[ended])       # untouched
        assert torch.equal(hk[ended], hd[ended])
        assert torch.equal(lk[ended], hl[ended])
        Hk2, hk2, lk2 = H.clone(), hd.clone(), hl.clone()
        d_k2, sc_k2 = kdir.fused_step_kernel(Hk2, *args, hk2, lk2, ls_ok,
                                             run)
        assert torch.equal(d_k, d_k2) and torch.equal(sc_k, sc_k2)
        assert torch.equal(Hk, Hk2)


def _fe_specs():
    """BASELINE config #1's data under the three one-step discs, config
    #2's shape (D=100, N_data=121, Hermite–Simpson) and config #5's width
    (D=400, trapezoid)."""
    spec, tw = _main_spec()
    out = [(dataclasses.replace(spec, disc=d), 4)
           for d in ("euler", "trapezoid", "forwardmap")]
    tw2 = lorenz96_twin(D=100, N_data=121, n_obs=40, sigma=1.0)
    out.append((build_spec(lorenz96, 100, tw2["Y"], tw2["t"], tw2["Lidx"],
                           tw2["RM"], disc="SimpsonHermite",
                           P=np.array([4.0]), pidx=[0]), 8))
    tw5 = lorenz96_twin(D=400, N_data=161, n_obs=100)
    out.append((build_spec(lorenz96, 400, tw5["Y"], tw5["t"], tw5["Lidx"],
                           tw5["RM"], disc="trapezoid", P=np.array([4.0]),
                           pidx=[0]), 4))
    return out


def _k6_launches():
    return (fe.FWD_LAUNCHES + fe.ONESTEP_VAG_LAUNCHES + fe.SH_FWD_LAUNCHES
            + fe.SH_VAG_LAUNCHES)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_fe_kernels_match_plain(cuda, dtype, tol):
    """K6's four kernels against their plain versions: the value (the
    partials' sum) within tol relative, the gradient rows and F's
    gradient within tol of max|g|, scalar and (N_f-1, D) rf; one launch
    each; repeats bit-identical."""
    rng = np.random.default_rng(0)
    for spec, B in _fe_specs():
        c = fe.fe_consts(spec, dtype, cuda, block_n=64)
        X = torch.tensor(rng.normal(2.0, 2.0, (B, spec.N_f, spec.D)),
                         dtype=dtype, device=cuda)
        pest = torch.tensor(4.0 + rng.normal(size=(B, 1)), dtype=dtype,
                            device=cuda)
        for rf in (1e-2, torch.tensor(rng.uniform(
                0.5, 2.0, (spec.N_f - 1, spec.D)) * 1e-2, dtype=dtype,
                device=cuda)):
            n0 = _k6_launches()
            p_k = fe.fe_partials(X, pest, rf, c)
            g_k, gp_k = fe.fe_adjoint(X, pest, rf, c)
            torch.cuda.synchronize()
            assert _k6_launches() == n0 + 2
            Xc, pc = X.cpu(), pest.cpu()
            rc = rf.cpu() if isinstance(rf, torch.Tensor) else rf
            cc = fe.fe_consts(spec, dtype, "cpu", block_n=64)
            p_r = fe.fe_partials(Xc, pc, rc, cc)
            g_r, gp_r = fe.fe_adjoint(Xc, pc, rc, cc)
            v_k, v_r = p_k.sum(1).cpu(), p_r.sum(1)
            assert float(torch.max(torch.abs(v_k - v_r) / v_r.abs())) <= tol
            s = torch.amax(torch.abs(g_r), dim=(1, 2))
            assert float(torch.max(torch.amax(torch.abs(
                g_k.cpu() - g_r), dim=(1, 2)) / s)) <= tol
            assert float(torch.max(torch.abs(
                gp_k.sum(1).cpu() - gp_r.sum(1)) / s)) <= tol
            assert torch.equal(p_k, fe.fe_partials(X, pest, rf, c))
            assert torch.equal(g_k, fe.fe_adjoint(X, pest, rf, c)[0])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_fe_nakl_kernels_match_plain(cuda, dtype, tol):
    """K6 on NaKL with its stimulus (BASELINE config #3's twin, cut to
    N=601): the four discs, Pidx [1..5] and the 18 in the log model,
    scalar and (N_f-1, 4) rf, the kernels against their plain versions
    (the torch model, torch.func.vjp) on the CPU: the value within tol
    relative, the gradient rows and the full parameter gradient within
    tol of max|g|; one launch each; repeats bit-identical."""
    from varanneal_tpu_torch.models import (NAKL_G_IDX, NAKL_TAU_IDX,
                                            nakl_log_model, nakl_ss_gates)
    from varanneal_tpu_torch.twin import nakl_twin
    tw = nakl_twin(N=601, dt=0.04, sigma=1.0, seed=7)
    rng = np.random.default_rng(5)
    for disc in ("euler", "trapezoid", "forwardmap", "SimpsonHermite"):
        for pidx, log_idx in (([1, 2, 3, 4, 5], ()),
                              (list(range(1, 19)),
                               NAKL_TAU_IDX + NAKL_G_IDX)):
            f, P = nakl_log_model(log_idx)
            spec = build_spec(f, 4, tw["V"], tw["t"], [0], 1.0, disc=disc,
                              P=P, pidx=pidx, stim=tw["stim"])
            c = fe.fe_consts(spec, dtype, cuda, block_n=64)
            B = 3
            V = np.interp(np.arange(spec.N_f) * 600 / (spec.N_f - 1),
                          np.arange(601), tw["V"][:, 0])
            g = np.stack(nakl_ss_gates(V), axis=-1)
            X = torch.tensor(np.concatenate(
                [np.broadcast_to(V[:, None], (B, spec.N_f, 1)),
                 np.clip(g + 0.05 * rng.normal(size=(B, spec.N_f, 3)), 0,
                         1)], axis=-1), dtype=dtype, device=cuda)
            pb = np.asarray(P)[pidx]
            pest = torch.tensor(pb + 0.05 * np.abs(pb) * rng.normal(
                size=(B, len(pidx))), dtype=dtype, device=cuda)
            for rf in (1e-3, torch.tensor(np.broadcast_to(
                    1e-3 * np.array([1.0, 1e3, 1e3, 1e3]),
                    (spec.N_f - 1, 4)).copy(), dtype=dtype, device=cuda)):
                n0 = _k6_launches()
                p_k = fe.fe_partials(X, pest, rf, c)
                g_k, gp_k = fe.fe_adjoint(X, pest, rf, c)
                torch.cuda.synchronize()
                assert _k6_launches() == n0 + 2
                rc = rf.cpu() if isinstance(rf, torch.Tensor) else rf
                cc = fe.fe_consts(spec, dtype, "cpu", block_n=64)
                p_r = fe.fe_partials(X.cpu(), pest.cpu(), rc, cc)
                g_r, gp_r = fe.fe_adjoint(X.cpu(), pest.cpu(), rc, cc)
                v_k, v_r = p_k.sum(1).cpu(), p_r.sum(1)
                assert float(torch.max(torch.abs(v_k - v_r)
                                       / v_r.abs())) <= tol
                s = torch.maximum(torch.amax(torch.abs(g_r), dim=(1, 2)),
                                  torch.amax(torch.abs(gp_r), dim=1))
                assert float(torch.max(torch.amax(torch.abs(
                    g_k.cpu() - g_r), dim=(1, 2)) / s)) <= tol
                assert float(torch.max(torch.amax(torch.abs(
                    gp_k.cpu() - gp_r), dim=1) / s)) <= tol
                again = fe.fe_adjoint(X, pest, rf, c)
                assert torch.equal(p_k, fe.fe_partials(X, pest, rf, c))
                assert torch.equal(g_k, again[0])
                assert torch.equal(gp_k, again[1])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_fe_row_models_match_plain(cuda, dtype, tol):
    """K6 on Colpitts (its twin cut to N=201, eta or all four estimated)
    and Lorenz-63 (an RK4 path, rho or all three): the four discs, scalar
    and (N_f-1, 3) rf, B = 1 and 3, the kernels against their plain
    versions (the torch model, torch.func.vjp) on the CPU: the value
    within tol relative, the gradient rows and the full parameter
    gradient within tol of max|g|; one launch each; repeats
    bit-identical."""
    from varanneal_tpu_torch.models import (COLPITTS_P_TRUE, colpitts,
                                            lorenz63)
    from varanneal_tpu_torch.twin import _rk4_np, colpitts_twin
    tw = colpitts_twin(N_data=201)
    P63 = np.array([10.0, 28.0, 8.0 / 3.0])

    def l63_np(x):
        return np.array([P63[0] * (x[1] - x[0]), x[0] * (P63[1] - x[2])
                         - x[1], x[0] * x[1] - P63[2] * x[2]])
    x63 = _rk4_np(l63_np, _rk4_np(l63_np, [1.0, 1.0, 20.0], 0.01,
                                  500)[-1], 0.01, 200)
    rng = np.random.default_rng(6)
    problems = (
        (colpitts, tw["traj"], tw["Y"], tw["t"], tw["Lidx"],
         np.asarray(COLPITTS_P_TRUE), ([3], [0, 1, 2, 3])),
        (lorenz63, x63, x63[:, [0, 2]], 0.01 * np.arange(201), [0, 2], P63,
         ([1], [0, 1, 2])))
    for f, traj, Y, t, Lidx, P, pidxs in problems:
        for disc in ("euler", "trapezoid", "forwardmap", "SimpsonHermite"):
            for pidx in pidxs:
                spec = build_spec(f, 3, Y, t, Lidx, 1.0, disc=disc, P=P,
                                  pidx=pidx)
                c = fe.fe_consts(spec, dtype, cuda, block_n=64)
                cc = fe.fe_consts(spec, dtype, "cpu", block_n=64)
                s_ = np.arange(spec.N_f) * 200 / (spec.N_f - 1)
                Xn = np.stack([np.interp(s_, np.arange(201), traj[:, d])
                               for d in range(3)], axis=-1)
                for B in (1, 3):
                    X = torch.tensor(Xn + 0.05 * np.std(traj, axis=0)
                                     * rng.normal(size=(B, spec.N_f, 3)),
                                     dtype=dtype, device=cuda)
                    pb = P[pidx]
                    pest = torch.tensor(pb + 0.05 * np.abs(pb) * rng.normal(
                        size=(B, len(pidx))), dtype=dtype, device=cuda)
                    for rf in (1e-2, torch.tensor(rng.uniform(
                            0.5, 2.0, (spec.N_f - 1, 3)), dtype=dtype,
                            device=cuda)):
                        n0 = _k6_launches()
                        p_k = fe.fe_partials(X, pest, rf, c)
                        g_k, gp_k = fe.fe_adjoint(X, pest, rf, c)
                        torch.cuda.synchronize()
                        assert _k6_launches() == n0 + 2
                        rc = rf.cpu() if isinstance(rf, torch.Tensor) else rf
                        p_r = fe.fe_partials(X.cpu(), pest.cpu(), rc, cc)
                        g_r, gp_r = fe.fe_adjoint(X.cpu(), pest.cpu(), rc,
                                                  cc)
                        v_k, v_r = p_k.sum(1).cpu(), p_r.sum(1)
                        assert float(torch.max(torch.abs(v_k - v_r)
                                               / v_r.abs())) <= tol
                        sc = torch.maximum(
                            torch.amax(torch.abs(g_r), dim=(1, 2)),
                            torch.amax(torch.abs(gp_r), dim=1))
                        assert float(torch.max(torch.amax(torch.abs(
                            g_k.cpu() - g_r), dim=(1, 2)) / sc)) <= tol
                        assert float(torch.max(torch.amax(torch.abs(
                            gp_k.cpu() - gp_r), dim=1) / sc)) <= tol
                        again = fe.fe_adjoint(X, pest, rf, c)
                        assert torch.equal(p_k, fe.fe_partials(X, pest, rf,
                                                               c))
                        assert torch.equal(g_k, again[0])
                        assert torch.equal(gp_k, again[1])


def test_fe_action_on_the_card(cuda):
    """engine='pallas' on the card: K6 forward and backward once an
    evaluation, the action's value and gradient within 1e-12 of the
    autograd action's in f64 (config #2's shape, two members)."""
    spec = _fe_specs()[3][0]
    act, parts = fe.select_action(spec, 1e-3, engine="pallas",
                                  dtype=torch.float64, device=cuda)
    assert act.engine == "pallas"
    act_x, _ = make_action(spec, device=cuda)
    XP = torch.tensor(np.random.default_rng(3).normal(
        size=(2, spec.n_dof)), device=cuda)
    n0 = (fe.SH_FWD_LAUNCHES, fe.SH_VAG_LAUNCHES)
    x = XP.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(act(x, 1e-3).sum(), x)
    assert (fe.SH_FWD_LAUNCHES, fe.SH_VAG_LAUNCHES) == (n0[0] + 1,
                                                         n0[1] + 1)
    x2 = XP.clone().requires_grad_(True)
    A_x = act_x(x2, 1e-3)
    (g_x,) = torch.autograd.grad(A_x.sum(), x2)
    torch.testing.assert_close(act(XP, 1e-3), A_x.detach(), rtol=1e-12,
                               atol=0)
    assert float(torch.max(torch.abs(g - g_x))
                 / torch.max(torch.abs(g_x))) <= 1e-12


def _sh_cases():
    """Config #2's Hermite–Simpson shape (Lorenz-96 D=100, B=8) and
    config #3's twin cut to N=601 (NaKL with its stimulus, Pidx [1..5],
    B=3), each (spec, X, pest) drawn from numpy seed 9."""
    from varanneal_tpu_torch.models import NAKL_P_TRUE, nakl
    from varanneal_tpu_torch.twin import nakl_twin
    rng = np.random.default_rng(9)
    spec2, B2 = _fe_specs()[3]
    out = [(spec2, rng.normal(2.0, 2.0, (B2, spec2.N_f, spec2.D)),
            4.0 + rng.normal(size=(B2, 1)))]
    tw = nakl_twin(N=601, dt=0.04, sigma=1.0, seed=7)
    P = np.asarray(NAKL_P_TRUE, float)
    spec3 = build_spec(nakl, 4, tw["V"], tw["t"], [0], 1.0,
                       disc="SimpsonHermite", P=P, pidx=[1, 2, 3, 4, 5],
                       stim=tw["stim"])
    X = np.concatenate([rng.uniform(-75, -45, (3, spec3.N_f, 1)),
                        rng.uniform(0.05, 0.95, (3, spec3.N_f, 3))], -1)
    pest = P[[1, 2, 3, 4, 5]] * (1 + 0.05 * rng.normal(size=(3, 5)))
    out.append((spec3, X, pest))
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_fe_sh_vag_matches_plain(cuda, dtype, tol):
    """The fused Hermite–Simpson launch (fe_sh_vag) against its plain
    version on the CPU and against fe_sh_fwd on the card: the value within
    tol relative, the joined gradient rows and the full parameter gradient
    within tol of max|g|, scalar and (N_f-1, D) rf; one launch; its
    partials bit-equal to fe_sh_fwd's (one partition); repeats
    bit-identical."""
    for spec, X_np, p_np in _sh_cases():
        c = fe.fe_consts(spec, dtype, cuda, block_n=64)
        cc = fe.fe_consts(spec, dtype, "cpu", block_n=64)
        X = torch.tensor(X_np, dtype=dtype, device=cuda)
        pest = torch.tensor(p_np, dtype=dtype, device=cuda)
        for rf in (1e-3, torch.tensor(np.full((spec.N_f - 1, spec.D),
                                              1e-3), dtype=dtype,
                                      device=cuda)):
            n0 = fe.SH_VAG_LAUNCHES
            out = fe.sh_vag_kernel(X, pest, rf, c)
            torch.cuda.synchronize()
            assert fe.SH_VAG_LAUNCHES == n0 + 1
            rc = rf.cpu() if isinstance(rf, torch.Tensor) else rf
            ref = fe.sh_vag_reference(X.cpu(), pest.cpu(), rc, cc)
            v_k, v_r = out[0].sum(1).cpu(), ref[0].sum(1)
            assert float(torch.max(torch.abs(v_k - v_r)
                                   / v_r.abs())) <= tol
            P = fe.full_params(pest.cpu(), cc)
            g_k = fe.sh_join(*(t.cpu() for t in out[1:4]), cc)
            g_r = fe.sh_join(*ref[1:4], cc)
            gp_k = fe.param_grad(out[4].cpu(), P, cc)
            gp_r = fe.param_grad(ref[4], P, cc)
            s = torch.maximum(torch.amax(torch.abs(g_r), dim=(1, 2)),
                              torch.amax(torch.abs(gp_r), dim=1))
            assert float(torch.max(torch.amax(torch.abs(g_k - g_r),
                                              dim=(1, 2)) / s)) <= tol
            assert float(torch.max(torch.amax(torch.abs(gp_k - gp_r),
                                              dim=1) / s)) <= tol
            assert torch.equal(out[0], fe.sh_fwd_kernel(X, pest, rf, c))
            again = fe.sh_vag_kernel(X, pest, rf, c)
            assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_fe_value_and_grad_one_launch(cuda):
    """K6's action.value_and_grad on the card: one fused launch a call
    and no value-only launch, fe_sh_vag under Hermite–Simpson and
    fe_onestep_vag under a one-step disc; in f64 the value and gradient
    within 1e-12 of the autograd action's."""
    from varanneal_tpu_torch.ops import value_and_grad
    for spec in (_fe_specs()[3][0], _fe_specs()[1][0]):
        act, _ = fe.select_action(spec, 1e-3, engine="pallas",
                                  dtype=torch.float64, device=cuda)
        vag = value_and_grad(act)
        assert vag is act.value_and_grad
        XP = torch.tensor(np.random.default_rng(4).normal(
            size=(2, spec.n_dof)), device=cuda)
        n0 = (fe.SH_VAG_LAUNCHES, fe.SH_FWD_LAUNCHES, fe.FWD_LAUNCHES,
              fe.ONESTEP_VAG_LAUNCHES)
        A, G = vag(XP, 1e-3)
        torch.cuda.synchronize()
        n1 = (fe.SH_VAG_LAUNCHES, fe.SH_FWD_LAUNCHES, fe.FWD_LAUNCHES,
              fe.ONESTEP_VAG_LAUNCHES)
        want = ((1, 0, 0, 0) if spec.disc == "SimpsonHermite"
                else (0, 0, 0, 1))
        assert tuple(b - a for a, b in zip(n0, n1)) == want
        A_x, G_x = value_and_grad(make_action(spec, device=cuda)[0])(
            XP, 1e-3)
        torch.testing.assert_close(A, A_x, rtol=1e-12, atol=0)
        assert float(torch.max(torch.abs(G - G_x))
                     / torch.max(torch.abs(G_x))) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fe_sh_envelope_edge(cuda, dtype):
    """Lorenz-96 under Hermite–Simpson at the widest D the envelope takes
    (one interval a block, its shared memory as fe._smem_bytes sizes it
    for the envelope and the launch sizes it, 1,024 threads): both
    launches run and match their plain versions; one wider is refused."""
    spec = _fe_specs()[3][0]
    edge = {torch.float64: 3624, torch.float32: 7256}[dtype]
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    assert not fe.fe_kernel_supported(
        dataclasses.replace(spec, D=edge + 1), 0.0, dtype)
    wide = dataclasses.replace(spec, D=edge)
    c = fe.fe_consts(wide, dtype, cuda)
    assert c.rows(1) == 1
    rng = np.random.default_rng(5)
    X = torch.tensor(rng.normal(2.0, 2.0, (1, wide.N_f, edge)), dtype=dtype,
                     device=cuda)
    pest = torch.tensor([[8.0]], dtype=dtype, device=cuda)
    parts = fe.sh_fwd_kernel(X, pest, 1e-3, c)
    out = fe.sh_vag_kernel(X, pest, 1e-3, c)
    ref = fe.sh_vag_reference(X, pest, 1e-3, c)
    assert torch.equal(parts, out[0])
    v_r = ref[0].sum(1)
    assert float(torch.max(torch.abs(out[0].sum(1) - v_r)
                           / v_r.abs())) <= tol
    g_k, g_r = fe.sh_join(*out[1:4], c), fe.sh_join(*ref[1:4], c)
    assert float(torch.max(torch.abs(g_k - g_r))
                 / torch.max(torch.abs(g_r))) <= tol


def _agt_specs():
    """K5's shapes: the main path's (D=20, N=161), D=40 and D=64 (the
    wide walk), and D=64 at N=1,001, whose (N-1)·D f32 residuals (256 KB)
    no block could hold."""
    spec, tw = _main_spec()
    out = [(spec, tw)]
    for D, N, n_obs in ((40, 161, 10), (64, 161, 16), (64, 1001, 16)):
        twd = lorenz96_twin(D=D, N_data=N, n_obs=n_obs)
        out.append((build_spec(lorenz96, D, twd["Y"], twd["t"],
                               twd["Lidx"], twd["RM"], disc="trapezoid",
                               P=np.array([4.0]), pidx=[0]), twd))
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_agt_kernel_matches_plain(cuda, dtype, tol):
    """K5 (kernels/csrc/agt_kernel.cu) against its plain version at the main
    path's shape, at D = 40 and 64 and at D = 64 with N = 1,001, the three
    one-step rules × scalar and (N_f-1, D) rf: value within tol relative,
    gradient within tol of max|g|; one launch a call and bit-identical
    repeats."""
    for spec, tw in _agt_specs():
        Z = torch.tensor(_draw(spec, tw, 4), dtype=dtype, device=cuda)
        W = np.random.default_rng(5).uniform(0.5, 2.0,
                                             (spec.N_f - 1, spec.D))
        for disc in ("trapezoid", "euler", "forwardmap"):
            c = ag.agt_consts(dataclasses.replace(spec, disc=disc), cuda,
                              dtype)
            for rf in (3.0, torch.tensor(3.0 * W, dtype=dtype, device=cuda)):
                n0 = ag.AGT_LAUNCHES
                A, G = ag.agt_kernel(Z, rf, c)
                torch.cuda.synchronize()
                assert ag.AGT_LAUNCHES == n0 + 1
                A_r, G_r = ag.ag_reference(Z, rf, c)
                assert float(torch.max(torch.abs(A - A_r)
                                       / torch.abs(A_r))) <= tol
                scale = torch.amax(torch.abs(G_r), dim=1, keepdim=True)
                assert float(torch.max(torch.abs(G - G_r) / scale)) <= tol
                A2, G2 = ag.agt_kernel(Z, rf, c)
                assert torch.equal(A, A2) and torch.equal(G, G2)


def _onestep_cases():
    """Config #1's data under the three one-step rules (Lorenz-96 D=20,
    N=161) and config #3's twin cut to N=601 under the three rules (NaKL,
    Pidx [1..5], with its stimulus and without), each (spec, X, pest, rf
    scale) from numpy seed 11."""
    from varanneal_tpu_torch.models import NAKL_P_TRUE, nakl
    from varanneal_tpu_torch.twin import nakl_twin
    rng = np.random.default_rng(11)
    spec, _ = _main_spec()
    out = []
    for disc in ("trapezoid", "euler", "forwardmap"):
        sp = dataclasses.replace(spec, disc=disc)
        out.append((sp, rng.normal(2.0, 2.0, (4, sp.N_f, sp.D)),
                    4.0 + rng.normal(size=(4, 1)), 3e-2))
    tw = nakl_twin(N=601, dt=0.04, sigma=1.0, seed=7)
    P = np.asarray(NAKL_P_TRUE, float)
    for disc in ("trapezoid", "euler", "forwardmap"):
        for stim in (tw["stim"], None):
            sp = build_spec(nakl, 4, tw["V"], tw["t"], [0], 1.0, disc=disc,
                            P=P, pidx=[1, 2, 3, 4, 5], stim=stim)
            X = np.concatenate([rng.uniform(-75, -45, (4, sp.N_f, 1)),
                                rng.uniform(0.05, 0.95, (4, sp.N_f, 3))], -1)
            pest = P[[1, 2, 3, 4, 5]] * (1 + 0.05 * rng.normal(size=(4, 5)))
            out.append((sp, X, pest, 2e-3))
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_fe_onestep_vag_matches_plain(cuda, dtype, tol):
    """The fused one-step launch (fe_onestep_vag) against its plain version
    on the CPU, Lorenz-96 and NaKL under the three rules × scalar and
    (N_f-1, D) rf, B = 1 and 4: the value within tol relative, the
    gradient rows and the full parameter gradient within tol of max|g|;
    one launch a call; its partials bit-equal to fe_onestep_fwd's (one
    partition); repeats bit-identical."""
    for spec, X_np, p_np, rf0 in _onestep_cases():
        c = fe.fe_consts(spec, dtype, cuda, block_n=64)
        cc = fe.fe_consts(spec, dtype, "cpu", block_n=64)
        W = np.random.default_rng(6).uniform(0.5, 2.0,
                                             (spec.N_f - 1, spec.D))
        for B in (1, 4):
            X = torch.tensor(X_np[:B], dtype=dtype, device=cuda)
            pest = torch.tensor(p_np[:B], dtype=dtype, device=cuda)
            for rf in (rf0, torch.tensor(rf0 * W, dtype=dtype,
                                         device=cuda)):
                n0 = fe.ONESTEP_VAG_LAUNCHES
                out = fe.onestep_vag_kernel(X, pest, rf, c)
                torch.cuda.synchronize()
                assert fe.ONESTEP_VAG_LAUNCHES == n0 + 1
                rc = rf.cpu() if isinstance(rf, torch.Tensor) else rf
                ref = fe.onestep_vag_reference(X.cpu(), pest.cpu(), rc, cc)
                v_k, v_r = out[0].sum(1).cpu(), ref[0].sum(1)
                assert float(torch.max(torch.abs(v_k - v_r)
                                       / v_r.abs())) <= tol
                P = fe.full_params(pest.cpu(), cc)
                gp_k = fe.param_grad(out[2].cpu(), P, cc)
                gp_r = fe.param_grad(ref[2], P, cc)
                s = torch.maximum(torch.amax(torch.abs(ref[1]), dim=(1, 2)),
                                  torch.amax(torch.abs(gp_r), dim=1))
                assert float(torch.max(torch.amax(torch.abs(
                    out[1].cpu() - ref[1]), dim=(1, 2)) / s)) <= tol
                assert float(torch.max(torch.amax(
                    torch.abs(gp_k - gp_r), dim=1) / s)) <= tol
                assert torch.equal(out[0],
                                   fe.onestep_fwd_kernel(X, pest, rf, c))
                again = fe.onestep_vag_kernel(X, pest, rf, c)
                assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pack_kernel_matches_k2(cuda, dtype):
    """K8 (kernels/csrc/pack_kernel.cu): one launch a call; at pack 2
    (G = 256, K2's layout plan) bit-identical to K2, the batch of 5
    padded, unbounded and in phase 12's box; at packs 3, 4 and 8 (G = 64,
    64, 32) K2's counts, f64 x within 1e-8 and f32 f within 1e-4 relative
    of the plain version's; the block's shared memory as pack_layout
    counts it; every built kernel within 255 registers a
    thread, and in f32 with no more local memory than K2's kernel of the
    same chunk: the call frame of the non-inlined solve_one's
    by-reference arguments (184 B; 200 B bounded), no spill (the first
    port's packs of 3–8 spilled: 472 B)."""
    spec, tw = _main_spec()
    c = ag.ag_consts(spec, cuda, dtype)
    opts = LBFGSOptions(maxiter=30, m=5, pgtol=1e-4, ftol=1e-6)
    Z = torch.tensor(_draw(spec, tw, 5), dtype=dtype, device=cuda)
    rf = rung_rf(4e-6 * tw["RM"], 1.5, 50, dtype)
    lo, hi = (torch.tensor(b, dtype=dtype, device=cuda) for b in build_bounds(
        spec, [(-6.0, 6.0)] * 20 + [(3.0, 6.0)], np.float64))
    for box in ((None, None), (lo, hi)):
        n0 = solve_pack.PACK_LAUNCHES
        r8 = solve_pack.pack_kernel(Z, rf, c, opts, 2, *box)
        torch.cuda.synchronize()
        assert solve_pack.PACK_LAUNCHES == n0 + 1
        r2 = solve.solve_kernel(Z, rf, c, opts, *box)
        assert all(torch.equal(u, v) for u, v in zip(r8, r2))
    for pack in (3, 4, 8):
        rk = solve_pack.pack_kernel(Z, rf, c, opts, pack)
        rp = solve_pack.pack_reference(Z, rf, c, opts, pack)
        for k in ("niter", "nfev", "status"):
            assert torch.equal(getattr(rk, k), getattr(rp, k))
        if dtype == torch.float64:
            scale = torch.amax(torch.abs(rp.x), dim=1, keepdim=True)
            assert float(torch.max(torch.abs(rk.x - rp.x) / scale)) <= 1e-8
        else:
            assert float(torch.max(torch.abs(rk.f - rp.f)
                                   / torch.abs(rp.f))) <= 1e-4
        assert solve_pack.pack_supported(spec, 1.0, opts, pack, dtype,
                                         device=cuda)
    lib = solve_pack._entries("l96")[0]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for pack in (1, 2, 3, 4, 8):       # the block's shared memory: C's
        for B in (4, 264):
            lay = solve_pack.pack_layout(spec, dtype, pack, 5, B, False, sms)
            assert lib.va_l96_pack_smem(
                spec.D, spec.n_dof, 5, pack, solve_pack.pack_group(pack),
                lay.flags, int(dtype == torch.float64)) == lay.smem_bytes
    for G in solve_pack.GROUPS:
        for bounded in (False, True):
            for layout in ((0, solve.VECTORS | solve.HISTORY) if G == 256
                           else (0,)):
                a = solve_pack.kernel_attrs(G, dtype, bounded, layout)
                assert a["regs"] <= 255 and a["max_threads"] >= 256
                k2 = solve.kernel_attrs(False, dtype, bounded, layout)
                if dtype == torch.float32:
                    assert a["local_bytes"] <= k2["local_bytes"], (
                        G, bounded, layout, a, k2)


def _rule_specs():
    """The main path's data under the four rules (D=20, N=161) and a
    Hermite–Simpson problem in the wide walk (D=40, N_data=21)."""
    spec, tw = _main_spec()
    out = [(build_spec(lorenz96, 20, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                       disc=d, P=np.array([4.0]), pidx=[0]), tw)
           for d in ("trapezoid", "euler", "forwardmap", "SimpsonHermite")]
    tw40 = lorenz96_twin(D=40, N_data=21, n_obs=16)
    out.append((build_spec(lorenz96, 40, tw40["Y"], tw40["t"], tw40["Lidx"],
                           tw40["RM"], disc="SimpsonHermite",
                           P=np.array([4.0]), pidx=[0]), tw40))
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_rule_entries_match_plain(cuda, dtype, tol):
    """K1 and K4's rules' entries (kernels/csrc/ag_rules_kernel.cu) against
    their plain version under each rule × scalar and (N_f-1, D) rf (less
    the trapezoid/scalar pair, ag_kernel.cu's): value within tol relative,
    gradient within tol of max|g|, K4's combined value within tol; one
    launch a call, counted under its rule, and bit-identical repeats."""
    for spec, tw in _rule_specs():
        Z = torch.tensor(_draw(spec, tw, 4), dtype=dtype, device=cuda)
        W = np.random.default_rng(6).uniform(0.5, 2.0,
                                             (spec.N_f - 1, spec.D))
        c = ag.ag_consts(spec, cuda, dtype)
        for rf in (3.0, torch.tensor(3.0 * W, dtype=dtype, device=cuda)):
            diag = not isinstance(rf, float)
            if spec.disc == "trapezoid" and not diag:
                continue
            for comp in (False, True):
                key = ag.rule_key(spec.disc, diag, comp)
                n0 = ag.RULE_LAUNCHES.get(key, 0)
                out = ag.ag_kernel(Z, rf, c, comp)
                torch.cuda.synchronize()
                assert ag.RULE_LAUNCHES[key] == n0 + 1
                ref = ag.ag_reference(Z, rf, c, comp)
                assert float(torch.max(torch.abs(out[0] - ref[0])
                                       / torch.abs(ref[0]))) <= tol
                scale = torch.amax(torch.abs(ref[1]), dim=1, keepdim=True)
                assert float(torch.max(torch.abs(out[1] - ref[1])
                                       / scale)) <= tol
                if comp:
                    A_c, A_r = (ag.combine(o[2], rf, c) for o in (out, ref))
                    assert float(torch.max(torch.abs(A_c - A_r)
                                           / torch.abs(A_r))) <= tol
                again = ag.ag_kernel(Z, rf, c, comp)
                assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_sh_diag_rung_solve_matches_plain(cuda):
    """K2 (kernels/csrc/solve_rules_f32.cu) under Hermite–Simpson with
    an (N_f-1, D) rf, f32, short solves from data-informed draws at the
    main path's rung 50 (rf0 · 1.5^50 · W): the plain solve's niter, nfev
    and status, f within 1e-4 relative, and bit-identical repeats. (At rf
    1e-2 · W the problem is nearly flat and a solve ends on pgtol 1e-4 at
    a borderline |g|: on the H100 the kernel stopped one member at 9
    iterations with |g| 8.98e-5, the plain solve at 11 with 5.2e-5, as
    two f32 summation orders may.)"""
    spec, tw = _rule_specs()[3]
    Z = torch.tensor(_draw(spec, tw, 4, seed=2), dtype=torch.float32,
                     device=cuda)
    W = np.random.default_rng(7).uniform(0.5, 2.0, (spec.N_f - 1, spec.D))
    rf = torch.tensor(4e-6 * tw["RM"] * 1.5 ** 50 * W, dtype=torch.float32,
                      device=cuda)
    c = ag.ag_consts(spec, cuda, torch.float32)
    opts = LBFGSOptions(maxiter=12, m=5, pgtol=1e-4, ftol=1e-6)
    n0 = solve.RULE_LAUNCHES.get("K2/SimpsonHermite/diag", 0)
    rk = solve.solve_kernel(Z, rf, c, opts)
    torch.cuda.synchronize()
    assert solve.RULE_LAUNCHES["K2/SimpsonHermite/diag"] == n0 + 1
    rp = solve.solve_reference(Z, rf, c, opts)
    for k in ("niter", "nfev", "status"):
        assert torch.equal(getattr(rk, k), getattr(rp, k))
    assert float(torch.max(torch.abs(rk.f - rp.f) / torch.abs(rp.f))) <= 1e-4
    again = solve.solve_kernel(Z, rf, c, opts)
    assert torch.equal(rk.x, again.x) and torch.equal(rk.f, again.f)


def _row_problem(model, disc, N=41, jitter=0.05, B=4):
    """A row-level model's problem at N data rows and B draws near its
    path (the states within ``jitter`` of their spread, the estimated
    parameters within ``jitter``): NaKL's twin (V observed, the
    stimulus, Pidx [1..5]), Colpitts' (x1 observed, every parameter) and
    a Lorenz-63 path (x0 and x2 observed, rho)."""
    from varanneal_tpu_torch.models import (COLPITTS_P_TRUE, NAKL_P_TRUE,
                                            colpitts, lorenz63, nakl)
    from varanneal_tpu_torch.twin import _rk4_np, colpitts_twin, nakl_twin
    rng = np.random.default_rng(19)
    if model == "nakl":
        tw = nakl_twin(N=N, dt=0.04, sigma=1.0, seed=7, seg=8)
        spec = build_spec(nakl, 4, tw["V"], tw["t"], [0], 1.0, disc=disc,
                          P=np.asarray(NAKL_P_TRUE), pidx=[1, 2, 3, 4, 5],
                          stim=tw["stim"])
        traj = tw["traj"]
    elif model == "colpitts":
        tw = colpitts_twin(N_data=N)
        spec = build_spec(colpitts, 3, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                          disc=disc, P=np.asarray(COLPITTS_P_TRUE),
                          pidx=[0, 1, 2, 3])
        traj = tw["traj"]
    else:
        P = np.array([10.0, 28.0, 8.0 / 3.0])

        def fnp(x):
            return np.array([P[0] * (x[1] - x[0]), x[0] * (P[1] - x[2]) - x[1],
                             x[0] * x[1] - P[2] * x[2]])
        x0 = _rk4_np(fnp, np.array([1.0, 1.0, 20.0]), 0.01, 500)[-1]
        traj = _rk4_np(fnp, x0, 0.01, N - 1)
        spec = build_spec(lorenz63, 3, traj[:, [0, 2]] + rng.normal(
            size=(N, 2)), 0.01 * np.arange(N), [0, 2], 1.0, disc=disc, P=P,
            pidx=[1])
    at = np.arange(spec.N_f) * (traj.shape[0] - 1) / (spec.N_f - 1)
    path = np.stack([np.interp(at, np.arange(traj.shape[0]), traj[:, j])
                     for j in range(spec.D)], -1)
    pb = np.asarray(spec.P_base)[list(spec.pidx)]
    Z = [np.concatenate([
        (path + jitter * np.std(traj, 0) * rng.normal(size=path.shape)
         ).reshape(-1), pb * (1 + jitter * rng.normal(size=pb.shape))])
        for _ in range(B)]
    return spec, np.stack(Z)


ROW_MODELS = ("nakl", "colpitts", "l63")
RULES = ("trapezoid", "euler", "forwardmap", "SimpsonHermite")


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_row_entries_match_plain(cuda, dtype, tol):
    """K1 and K4 on the row-level models (kernels/csrc/ag_models_kernel.cu)
    against their plain version under each rule × scalar and (N_f-1, D)
    rf: value within tol relative, gradient within tol of max|g|, K4's
    combined value within tol; one launch a call, counted under its
    model, rule and rf kind, and bit-identical repeats."""
    for model in ROW_MODELS:
        for disc in RULES:
            spec, Z = _row_problem(model, disc)
            Z = torch.tensor(Z, dtype=dtype, device=cuda)
            W = np.random.default_rng(6).uniform(0.5, 2.0,
                                                 (spec.N_f - 1, spec.D))
            c = ag.ag_consts(spec, cuda, dtype)
            for rf in (0.5, torch.tensor(0.5 * W, dtype=dtype, device=cuda)):
                diag = not isinstance(rf, float)
                for comp in (False, True):
                    key = ag.model_key(model, disc, diag, comp)
                    n0 = ag.MODEL_LAUNCHES.get(key, 0)
                    out = ag.ag_kernel(Z, rf, c, comp)
                    torch.cuda.synchronize()
                    assert ag.MODEL_LAUNCHES[key] == n0 + 1
                    ref = ag.ag_reference(Z, rf, c, comp)
                    assert float(torch.max(torch.abs(out[0] - ref[0])
                                           / torch.abs(ref[0]))) <= tol, key
                    scale = torch.amax(torch.abs(ref[1]), dim=1,
                                       keepdim=True)
                    assert float(torch.max(torch.abs(out[1] - ref[1])
                                           / scale)) <= tol, key
                    if comp:
                        A_c, A_r = (ag.combine(o[2], rf, c)
                                    for o in (out, ref))
                        assert float(torch.max(torch.abs(A_c - A_r)
                                               / torch.abs(A_r))) <= tol
                    again = ag.ag_kernel(Z, rf, c, comp)
                    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("model", ROW_MODELS)
def test_row_solves_match_plain(cuda, model):
    """K2 and K3 on a row-level model (kernels/csrc/solve_models_*.cu)
    against their plain versions in f64: short solves under each rule,
    a scalar rf unbounded and an (N_f-1, D) rf bounded, and a 3-rung
    ladder under Hermite–Simpson of 5 iterations a rung from nearer the
    path (chip_smoke.py phase 33's K3 check): the same niter, nfev and
    status, f and A within 1e-8 relative, one launch a call,
    bit-identical repeats. (From the short solves' draws at 10
    iterations a rung, Colpitts' ladder parted by 1.7e-8 of A ~ 0.003 at
    its third rung on the H100, 3.5e-11 absolute: unconverged f64
    iterates under two orders of summation; NaKL's and Colpitts' rungs
    at this size do not reach pgtol 1e-8 in 1,000 iterations, so the
    converged-rung rule of test_ladder_kernel_matches_plain has no rung
    to hold.)"""
    opts = LBFGSOptions(maxiter=10, m=5, pgtol=1e-8, ftol=1e-12)
    for disc in RULES:
        spec, Z = _row_problem(model, disc)
        Z = torch.tensor(Z[:2], device=cuda)
        c = ag.ag_consts(spec, cuda, torch.float64)
        W = np.random.default_rng(8).uniform(0.5, 2.0,
                                             (spec.N_f - 1, spec.D))
        lo = torch.amin(Z, 0) - 0.05 * torch.abs(torch.amin(Z, 0)) - 1e-3
        hi = torch.amax(Z, 0) + 0.05 * torch.abs(torch.amax(Z, 0)) + 1e-3
        for rf, box in ((0.5, (None, None)),
                        (torch.tensor(0.5 * W, device=cuda), (lo, hi))):
            diag = box[0] is not None
            key = "K2/" + ag.model_key(model, disc, diag)
            n0 = solve.MODEL_LAUNCHES.get(key, 0)
            rk = solve.solve_kernel(Z, rf, c, opts, *box)
            torch.cuda.synchronize()
            assert solve.MODEL_LAUNCHES[key] == n0 + 1
            rp = solve.solve_reference(Z, rf, c, opts, *box)
            for k in ("niter", "nfev", "status"):
                assert torch.equal(getattr(rk, k), getattr(rp, k)), (key, k)
            assert float(torch.max(torch.abs(rk.f - rp.f)
                                   / torch.abs(rp.f))) <= 1e-8, key
            again = solve.solve_kernel(Z, rf, c, opts, *box)
            assert torch.equal(rk.x, again.x)
    # the ladder as chip_smoke.py phase 33 holds K3: from nearer the path
    # (a tenth of the short solves' jitter), 5 iterations a rung
    Z = torch.tensor(_row_problem(model, "SimpsonHermite", jitter=0.005)[1]
                     [:2], device=cuda)
    opts = LBFGSOptions(maxiter=5, m=5, pgtol=1e-8, ftol=1e-12)
    rfs = np.array([0.5, 1.0, 2.0])
    xk, rec = solve.ladder_kernel(Z, torch.tensor(rfs, device=cuda), c,
                                  opts)
    xr, recr = solve.ladder_reference(Z, rfs, c, opts)
    for k in ("niter", "nfev", "status"):
        assert torch.equal(rec[k], recr[k]), k
    assert float(torch.max(torch.abs(rec["A"] - recr["A"])
                           / torch.abs(recr["A"]))) <= 1e-8


def _pack_vs_plain(rk, rp, dtype, what):
    """K8's counts equal the plain version's; f64 f within 1e-8, f32 f
    within 1e-4 relative."""
    for k in ("niter", "nfev", "status"):
        assert torch.equal(getattr(rk, k), getattr(rp, k)), (what, k)
    tol = 1e-8 if dtype == torch.float64 else 1e-4
    assert float(torch.max(torch.abs(rk.f - rp.f)
                           / torch.abs(rp.f))) <= tol, what
    assert bool(torch.isfinite(rk.x).all()), what


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pack_nakl_neighbour_groups(cuda, dtype):
    """K8 on NaKL with its stimulus (kernels/csrc/pack_models_nakl_*.cu)
    at a pack of 8 (G = 32: eight one-warp groups a block) over B = 9
    members, two blocks, the second padded: every member, each group's
    neighbours included, equals the plain version (counts exact; f64 f
    within 1e-8, f32 within 1e-4), under Hermite–Simpson at an (N_f-1,
    4) rf and under the trapezoid rule at a scalar rf. A group's area is
    sized for its one warp (ag.ring_cols(c, 1)): at K2's eight warps'
    width NaKL's staged row and partials would run into the next group's
    area."""
    opts = LBFGSOptions(maxiter=10, m=5, pgtol=1e-8, ftol=1e-12)
    for disc in ("SimpsonHermite", "trapezoid"):
        spec, Z = _row_problem("nakl", disc, B=9)
        Z = torch.tensor(Z, dtype=dtype, device=cuda)
        c = ag.ag_consts(spec, cuda, dtype)
        W = np.random.default_rng(8).uniform(0.5, 2.0,
                                             (spec.N_f - 1, spec.D))
        rf = (torch.tensor(0.5 * W, dtype=dtype, device=cuda)
              if disc == "SimpsonHermite" else 0.5)
        key = "K8/" + ag.model_key("nakl", disc, disc == "SimpsonHermite")
        n0 = solve.MODEL_LAUNCHES.get(key, 0)
        rk = solve_pack.pack_kernel(Z, rf, c, opts, 8)
        torch.cuda.synchronize()
        assert solve.MODEL_LAUNCHES[key] == n0 + 1
        rp = solve_pack.pack_reference(Z, rf, c, opts, 8)
        _pack_vs_plain(rk, rp, dtype, (disc, "pack 8"))
        again = solve_pack.pack_kernel(Z, rf, c, opts, 8)
        assert all(torch.equal(a, b) for a, b in zip(rk, again))


@pytest.mark.parametrize("model", ROW_MODELS + ("l96",))
def test_pack_over_k2_envelope(cuda, model):
    """K8 off Lorenz-96's trapezoid rule with a scalar rf
    (kernels/csrc/pack_rules_*.cu, pack_models_*.cu) in f64 under each
    rule, a scalar rf unbounded and an (N_f-1, D) rf in a box: at packs 3
    and 5 (G = 64, 32) the plain version's counts and f within 1e-8, one
    launch a call counted under its rule or model; at pack 2 (G = 256)
    bit for bit K2 of the same problem, which it launches; the built
    kernels within 255 registers a thread and launchable at 256
    threads."""
    opts = LBFGSOptions(maxiter=10, m=5, pgtol=1e-8, ftol=1e-12)
    dtype = torch.float64
    for disc in RULES:
        if model == "l96":
            spec, tw = _rule_specs()[RULES.index(disc)]
            Z = _draw(spec, tw, 5)
        else:
            spec, Z = _row_problem(model, disc, B=5)
        Z = torch.tensor(Z, dtype=dtype, device=cuda)
        c = ag.ag_consts(spec, cuda, dtype)
        W = np.random.default_rng(8).uniform(0.5, 2.0,
                                             (spec.N_f - 1, spec.D))
        lo = torch.amin(Z, 0) - 0.05 * torch.abs(torch.amin(Z, 0)) - 1e-3
        hi = torch.amax(Z, 0) + 0.05 * torch.abs(torch.amax(Z, 0)) + 1e-3
        r0 = 3.0 if model == "l96" else 0.5
        for rf, box in ((r0, (None, None)),
                        (torch.tensor(r0 * W, device=cuda), (lo, hi))):
            diag = box[0] is not None
            if model == "l96" and disc == "trapezoid" and not diag:
                continue                  # pack_kernel.cu's pair
            key = "K8/" + (ag.model_key(model, disc, diag)
                           if model != "l96" else ag.rule_key(disc, diag))
            counts = (solve.MODEL_LAUNCHES if model != "l96"
                      else solve.RULE_LAUNCHES)
            for pack in (3, 5):
                n0 = counts.get(key, 0)
                rk = solve_pack.pack_kernel(Z, rf, c, opts, pack, *box)
                torch.cuda.synchronize()
                assert counts[key] == n0 + 1
                rp = solve_pack.pack_reference(Z, rf, c, opts, pack, *box)
                _pack_vs_plain(rk, rp, dtype, (key, pack))
            n2 = solve.RUNG_LAUNCHES
            r8 = solve_pack.pack_kernel(Z, rf, c, opts, 2, *box)
            assert solve.RUNG_LAUNCHES == n2          # counted as K8's
            r2 = solve.solve_kernel(Z, rf, c, opts, *box)
            assert all(torch.equal(u, v) for u, v in zip(r8, r2)), key
    fam = "l96_rule" if model == "l96" else model
    for dt in (torch.float32, torch.float64):
        for G in (64, 32):
            for bounded in (False, True):
                a = solve_pack.kernel_attrs(G, dt, bounded, 0, fam)
                assert a["regs"] <= 255 and a["max_threads"] >= 256, a

