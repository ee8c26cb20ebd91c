"""K2 and K3 of the port over Lorenz-96's four rules with a scalar or
(N_f-1, D) rf (varanneal_tpu_torch/kernels/solve.py; the kernels are
csrc/solve_rules_f32.cu and solve_rules_f64.cu, whose plain versions run
here on the CPU)
against the JAX package's Pallas kernels in interpret mode:

- K2's plain version against ``make_rung_solver`` under each rule × rf
  kind, bounded or not (the trapezoid rule with a scalar rf is
  tests/test_torch_solve.py's): equal niter, nfev and status, f64 f to
  1e-8 (that file's f64 rule);
- K3's plain version against ``make_ladder_solver`` under each other
  rule, three rungs: equal counts, A to 1e-8.

The data and RM are rounded to f32 first (the Pallas kernels embed them
so: tests/test_torch_solve.py); inputs come from numpy seeds."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from varanneal_tpu.kernels import ag_pallas, solve_pallas
from varanneal_tpu.opt import LBFGSOptions as OptsJax

from varanneal_tpu_torch.kernels import solve
from varanneal_tpu_torch.ops import pack
from varanneal_tpu_torch.opt import LBFGSOptions

from tests.test_torch_ag_rules import DISCS, _draws, _rf, _specs


@pytest.fixture(autouse=True)
def _interpret():
    ag_pallas.set_interpret(True)
    solve_pallas.set_interpret(True)
    yield
    ag_pallas.set_interpret(False)
    solve_pallas.set_interpret(False)


SHORT = dict(maxiter=10, m=5, pgtol=1e-4, ftol=1e-6)


@pytest.mark.parametrize("disc,rf_kind,bounded", [
    (d, k, b) for d in DISCS for k in ("scalar", "diag")
    for b in (False, True) if not (d == "trapezoid" and k == "scalar")])
def test_plain_k2_matches_jax(disc, rf_kind, bounded):
    """K2's plain version under each rule and rf kind, bounded or not,
    against the reference's ``make_rung_solver`` (interpret mode) on
    short f64 solves from data-informed draws: equal niter, nfev and
    status, f to 1e-8 relative (tests/test_torch_solve.py's f64 rule)."""
    tw, sj, st = _specs(disc, f32_data=True)
    rf = _rf(st, rf_kind) * 1e-2
    X0 = _draws(st, tw, 2, seed=6)
    kw, kwj = {}, {}
    if bounded:
        lo, hi = np.full(st.n_dof, -3.0), np.full(st.n_dof, 6.0)
        kw = dict(lower=lo, upper=hi)
        kwj = dict(lower=jnp.asarray(lo), upper=jnp.asarray(hi))
    jsolve = solve_pallas.make_rung_solver(sj, OptsJax(**SHORT), **kwj)
    psolve = solve.make_rung_solver(st, LBFGSOptions(**SHORT), device="cpu",
                                    **kw)
    rp = psolve(torch.tensor(X0), rf if np.ndim(rf) == 0
                else torch.tensor(rf))
    for b in range(2):
        rj = jsolve(jnp.asarray(X0[b]), jnp.asarray(rf))
        assert int(rp.niter[b]) == int(rj.niter) > 0
        assert int(rp.nfev[b]) == int(rj.nfev)
        assert int(rp.status[b]) == int(rj.status)
        np.testing.assert_allclose(float(rp.f[b]), float(rj.f), rtol=1e-8)


@pytest.mark.parametrize("disc", DISCS[1:])
def test_plain_k3_matches_jax(disc):
    """K3's plain version under each one-step rule and Hermite–Simpson,
    three rungs from near the twin's truth, against the reference's
    ``make_ladder_solver`` (interpret mode) in f64: equal counts rung by
    rung, A to 1e-8 relative. 20 iterations a rung: under the forward map
    (a poor model of the twin's flow, A ~ 35) the two f64 solvers part at
    round-off after ~25 iterations of the second rung (3e-5 in A at
    rung 3 after 40)."""
    tw, sj, st = _specs(disc, f32_data=True)
    rng = np.random.default_rng(7)
    traj = tw["traj"]
    if disc == "SimpsonHermite":
        mid = 0.5 * (traj[:-1] + traj[1:])
        traj = np.stack([traj[:-1], mid], 1).reshape(-1, st.D)
        traj = np.concatenate([traj, tw["traj"][-1:]])
    X0 = np.stack([pack(st, traj + 0.3 * rng.normal(size=traj.shape),
                        np.array([tw["F"] + 0.5 * rng.normal()]))
                   for _ in range(2)])
    opts = dict(maxiter=20, m=5, pgtol=1e-6, ftol=1e-10)
    rfs = np.array([1.0, 2.0, 4.0]) * float(tw["RM"])
    jl = solve_pallas.make_ladder_solver(sj, OptsJax(**opts), 3)
    pl = solve.make_ladder_solver(st, LBFGSOptions(**opts), 3, device="cpu")
    _, rp = pl(torch.tensor(X0), rfs)
    for b in range(2):
        _, rj = jl(jnp.asarray(X0[b]), jnp.asarray(rfs))
        for k in ("niter", "nfev", "status"):
            np.testing.assert_array_equal(rp[k][b].numpy(),
                                          np.asarray(rj[k]))
        np.testing.assert_allclose(rp["A"][b].numpy(), np.asarray(rj["A"]),
                                   rtol=1e-8)
