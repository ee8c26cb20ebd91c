"""K1, K2 and K3 on the card. K1, the nvcc-built CUDA kernel
(kernels/csrc/ag_kernel.cu), against its plain PyTorch version at the
main path's shape (Lorenz-96 D=20, N=161, L=8, B=4), f64 to 1e-12 and
f32 to 2e-5 relative (the card sums in another order than the plain
version); its launch count, its autograd Function, and a short f64
ladder through it. K2 and K3 (kernels/csrc/solve_kernel.cu) against
their plain versions in f64: the same niter, nfev and status on short
solves, the same actions over a short ladder, and bit-identical repeats.
Run on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

(--noconftest: tests/conftest.py sets up JAX, which that machine need not
have; this file imports no JAX.)
Without a card each test skips inside the test (the decision is never
made at import time, so every pytest-xdist worker collects the same
tests)."""

import numpy as np
import pytest
import torch

from varanneal_tpu_torch.anneal.ladder import rung_rf
from varanneal_tpu_torch.kernels import ag, solve
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, pack
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
