"""Box bounds in the port: the projection algorithm of opt/lbfgs.py, K2's
bounded branch (kernels/solve.py, whose plain version runs on the CPU)
and the bounded ladder with rf caps and floors, each against the JAX
package (varanneal_tpu/opt/lbfgs.py with bounded_algo='projection',
solve_pallas.make_rung_solver(lower=, upper=) in interpret mode,
anneal.run_ladder(rf_max=, rf_min=)). f64 comparisons hold the counts
exactly and x to 1e-8; f32 ones the counts exactly and f to 1e-4."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu.api import build_bounds as build_bounds_jax
from varanneal_tpu.kernels import dir_pallas, solve_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax
from varanneal_tpu.opt import lbfgs_minimize as lbfgs_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax

from varanneal_tpu_torch.anneal import run_ladder
from varanneal_tpu_torch.anneal.ladder import rung_rf
from varanneal_tpu_torch.api import build_bounds
from varanneal_tpu_torch.kernels import solve
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import (build_spec, make_action,
                                     spec_from_reference, value_and_grad)
from varanneal_tpu_torch.opt import LBFGSOptions, lbfgs_minimize
from varanneal_tpu_torch.parallel import random_ensemble_inits
from varanneal_tpu_torch.twin import lorenz96_twin
from tests.test_ladder_integration import make_twin


@pytest.fixture(autouse=True)
def _interp():
    solve_pallas.set_interpret(True)
    dir_pallas.set_interpret(True)
    yield
    solve_pallas.set_interpret(False)
    dir_pallas.set_interpret(False)


def _rosen_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen_vag_torch(x):
    with torch.enable_grad():
        z = x.detach().requires_grad_(True)
        f = torch.sum(100.0 * (z[:, 1:] - z[:, :-1] ** 2) ** 2
                      + (1.0 - z[:, :-1]) ** 2, dim=-1)
        (g,) = torch.autograd.grad(f.sum(), z)
    return f.detach(), g


def _jax_batched(vag, X0, lo, hi, opts):
    r = jax.jit(jax.vmap(lambda x0: lbfgs_jax(
        vag, x0, lower=jnp.asarray(lo), upper=jnp.asarray(hi),
        opts=opts)))(jnp.asarray(X0))
    return {k: np.asarray(getattr(r, k))
            for k in ("x", "f", "niter", "nfev", "status", "pgnorm")}


def _assert_same(rt, rj, xtol=1e-8):
    np.testing.assert_array_equal(rt.niter.numpy(), rj["niter"])
    np.testing.assert_array_equal(rt.nfev.numpy(), rj["nfev"])
    np.testing.assert_array_equal(rt.status.numpy(), rj["status"])
    scale = np.maximum(np.abs(rj["x"]).max(axis=1, keepdims=True), 1.0)
    np.testing.assert_allclose(rt.x.numpy() / scale, rj["x"] / scale,
                               rtol=0, atol=xtol)


@pytest.mark.parametrize("direction", ["compact", "two_loop"])
def test_projection_rosenbrock_matches_jax(direction):
    """A boxed Rosenbrock in f64, 3 members, solved to convergence: the
    same niter, nfev and status, x to 1e-8. Some sides are free (±inf);
    the minimum (1, ..., 1) lies outside the box, so bounds are active.
    ftol 1e-10 stops well above f64 rounding: an ftol near 1e-14 would
    stop on a relative decrease at the level of the two packages'
    different summation orders."""
    rng = np.random.default_rng(0)
    X0 = rng.uniform(-1.5, 1.5, (3, 6))
    lo = np.array([-np.inf, -0.5, -0.5, -0.5, -0.5, -0.5])
    hi = np.array([0.8, 0.8, np.inf, 0.8, 0.8, 0.8])
    kw = dict(m=5, maxiter=400, pgtol=1e-9, ftol=1e-10, direction=direction)
    rj = _jax_batched(jax.value_and_grad(_rosen_jax), X0, lo, hi,
                      OptsJax(**kw))
    rt = lbfgs_minimize(_rosen_vag_torch, torch.tensor(X0), lower=lo,
                        upper=hi, opts=LBFGSOptions(**kw), device="cpu")
    _assert_same(rt, rj)
    np.testing.assert_allclose(rt.pgnorm.numpy(), rj["pgnorm"], rtol=1e-6,
                               atol=1e-12)
    x = rt.x.numpy()
    assert np.all(x >= lo) and np.all(x <= hi)
    assert np.any(x == hi)


L96_BOX = [(-1.5, 7.5)] * 5 + [(3.0, 7.5)]


def _l96_problem():
    D, N_data, Lidx = 5, 21, (0, 1, 3)
    traj, Y, t, rng = make_twin(D=D, N_data=N_data, Lidx=Lidx)
    kw = dict(disc="trapezoid", P=np.array([4.0]), pidx=[0])
    spec_j = build_spec_jax(lorenz96_jax, D, Y, t, Lidx, 6.25, **kw)
    spec_t = build_spec(lorenz96, D, Y, t, Lidx, 6.25, **kw)
    X0 = np.empty((3, spec_t.n_dof))
    X0[:, :-1] = (traj[None] + 0.8 * rng.normal(size=(3,) + traj.shape)
                  ).reshape(3, -1)
    X0[:, -1] = 8.17 + 0.5 * rng.normal(size=3)
    return spec_j, spec_t, X0


def test_projection_l96_matches_jax():
    """The first 60 iterations of a boxed f64 Lorenz-96 solve (states in
    (-1.5, 7.5), F in (3, 7.5): the truth's F, 8.17, lies outside), each
    package with its own action: identical counts and x to 1e-8 (longer
    f64 solves drift apart on this landscape, tests/test_torch_lbfgs.py)."""
    spec_j, spec_t, X0 = _l96_problem()
    bnd = L96_BOX
    lo, hi = build_bounds(spec_t, bnd, np.float64)
    rf = 10.0
    kw = dict(m=5, maxiter=60, pgtol=1e-8, ftol=2.22e-9)
    act_j, _ = make_action_jax(spec_j)
    rj = _jax_batched(jax.value_and_grad(lambda z: act_j(z, rf)), X0, lo,
                      hi, OptsJax(**kw))
    vag = value_and_grad(make_action(spec_t, device="cpu")[0])
    rt = lbfgs_minimize(lambda z: vag(z, rf), torch.tensor(X0), lower=lo,
                        upper=hi, opts=LBFGSOptions(**kw), device="cpu")
    _assert_same(rt, rj)
    x = rt.x.numpy()
    assert np.all(x >= lo) and np.all(x <= hi)
    assert np.any(x == lo) or np.any(x == hi)


def test_projection_compact_pallas_matches_jax():
    """The bounded loop with direction='compact_pallas' (K7a; its plain
    version here, the JAX kernel in interpret mode) on a short f32 boxed
    Lorenz-96 solve: identical counts, f to 1e-4 relative."""
    spec_j, spec_t, X0 = _l96_problem()
    X0 = X0.astype(np.float32)
    bnd = L96_BOX
    lo, hi = build_bounds(spec_t, bnd, np.float32)
    rf = np.float32(10.0)
    kw = dict(m=5, maxiter=30, pgtol=1e-4, ftol=1e-6,
              direction="compact_pallas")
    act_j, _ = make_action_jax(spec_j)
    rj = _jax_batched(jax.value_and_grad(lambda z: act_j(z, rf)), X0, lo,
                      hi, OptsJax(**kw))
    vag = value_and_grad(make_action(spec_t, device="cpu")[0])
    rt = lbfgs_minimize(lambda z: vag(z, float(rf)), torch.tensor(X0),
                        lower=lo, upper=hi, opts=LBFGSOptions(**kw),
                        device="cpu")
    np.testing.assert_array_equal(rt.niter.numpy(), rj["niter"])
    np.testing.assert_array_equal(rt.nfev.numpy(), rj["nfev"])
    np.testing.assert_array_equal(rt.status.numpy(), rj["status"])
    np.testing.assert_allclose(rt.f.numpy(), rj["f"], rtol=1e-4)


@pytest.fixture(scope="module")
def problem():
    """As tests/test_torch_solve.py: the data and RM rounded to f32, which
    the Pallas kernels embed in f32 whatever the solve's dtype."""
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
BOX = [(-6.0, 6.0)] * 20 + [(3.0, 6.0)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bounded_rung_solver_matches_jax(problem, dtype):
    """K2's bounded branch: the port's rung solver with bounds (its plain
    version) against the JAX kernel's bounded branch, in the box of
    tests/test_solve_pallas.py (states (-6, 6), F (3, 6); bounds exact in
    f32, as the Pallas kernels embed them), short solves from data-informed
    draws (the data reach past 6, so the start is clipped) at β 0, 30 and
    60: identical niter, nfev and status; f64 x to 1e-8 relative, f32 f to
    1e-4; feasible; some component at a bound."""
    tw, sj, st = problem
    rng = np.random.default_rng(2)
    X0 = random_ensemble_inits(st, 2, seed=5, dtype=dtype)
    X0 = (X0 + rng.normal(0, 0.5, X0.shape)).astype(dtype)
    lo, hi = build_bounds(st, BOX, np.float64)
    lo_j, hi_j = build_bounds_jax(sj, BOX, np.float32)
    np.testing.assert_array_equal(lo, lo_j)
    np.testing.assert_array_equal(hi, hi_j)
    rf0 = dtype(4e-6 * tw["RM"])
    jsolve = jax.jit(jax.vmap(solve_pallas.make_rung_solver(
        sj, OptsJax(**SHORT), lower=lo_j, upper=hi_j), in_axes=(0, None)))
    psolve = solve.make_rung_solver(st, LBFGSOptions(**SHORT), lower=lo,
                                    upper=hi, device="cpu")
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    at_bound = False
    for beta in (0, 30, 60):
        rf = rung_rf(rf0, 1.5, beta, tdt)
        rp = psolve(torch.tensor(X0), rf)
        rj = jsolve(jnp.asarray(X0), jnp.asarray(rf, dtype))
        x = rp.x.numpy()
        assert np.all(x >= lo) and np.all(x <= hi)
        at_bound |= bool(np.any(x == lo) | np.any(x == hi))
        assert (rp.niter.numpy() > 0).all()
        for k in ("niter", "nfev", "status"):
            np.testing.assert_array_equal(getattr(rp, k).numpy(),
                                          np.asarray(getattr(rj, k)))
        if dtype == np.float32:
            np.testing.assert_allclose(rp.f.numpy(), np.asarray(rj.f),
                                       rtol=1e-4)
        else:
            xj = np.asarray(rj.x)
            scale = np.maximum(np.abs(xj).max(axis=1, keepdims=True), 1.0)
            np.testing.assert_allclose(x / scale, xj / scale, rtol=0,
                                       atol=1e-8)
    assert at_bound


def test_bounded_hook_matches_generic(problem):
    """run_ladder through K2's bounded rung solver against the generic
    two-loop projection ladder over K1's plain action: on the CPU both run
    the same plain arithmetic, so the records agree exactly."""
    from varanneal_tpu_torch.kernels import ag
    tw, sj, st = problem
    opts = LBFGSOptions(maxiter=60, m=5, pgtol=1e-6, ftol=1e-9,
                        direction="two_loop")
    lo, hi = build_bounds(st, BOX, np.float64)
    act, parts = ag.make_action_ag(st, device="cpu", dtype=torch.float64)
    X0 = torch.tensor(random_ensemble_inits(st, 2, seed=3))
    kw = dict(opts=opts, store_paths=True, device="cpu", lower=lo,
              upper=hi)
    rf0 = 4e-6 * tw["RM"]
    gen = run_ladder(act, parts, X0, np.arange(20, 23), rf0, 1.5, **kw)
    hook = run_ladder(act, parts, X0, np.arange(20, 23), rf0, 1.5,
                      rung_solver=solve.make_rung_solver(
                          st, opts, lower=lo, upper=hi, device="cpu"),
                      **kw)
    assert int(hook.niter.sum()) > 0
    for k in ("XP", "A", "ME", "FE", "status", "niter", "nfev", "pgnorm",
              "paths"):
        torch.testing.assert_close(getattr(hook, k), getattr(gen, k),
                                   rtol=0, atol=0)
    assert bool((hook.paths >= torch.tensor(lo)).all())


def test_rung_rf_caps_match_jax():
    """rf = min(max(RF0·α^β, rf_min), rf_max), the cap applied last, equal
    to the JAX ladder's expression in f32 and f64 at every β of 0..100,
    for scalar and per-component RF0, caps and floors."""
    rng = np.random.default_rng(3)
    rf0_v = rng.uniform(1e-5, 1e-3, (4, 3))
    rf_max = np.full((4, 3), np.inf)
    rf_max[0] = 1e2
    rf_min = np.zeros((4, 3))
    rf_min[1] = 5.0
    betas = np.arange(101)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.float64, torch.float64)):
        for rf0, mx, mn in ((np.float64(1.6e-5), None, None),
                            (rf0_v, rf_max, rf_min),
                            (np.float64(2e-4), rf_max, None),
                            (rf0_v, None, rf_min)):
            def ref(b):
                r = jnp.asarray(rf0, dt) * jnp.asarray(1.5, dt) ** \
                    jnp.asarray(b, dt)
                if mn is not None:
                    r = jnp.maximum(r, jnp.asarray(mn, dt))
                if mx is not None:
                    r = jnp.minimum(r, jnp.asarray(mx, dt))
                return np.asarray(r, np.float64)
            for b in betas:
                got = rung_rf(rf0, 1.5, b, tdt, rf_min=mn, rf_max=mx)
                np.testing.assert_array_equal(np.asarray(got), ref(b))
