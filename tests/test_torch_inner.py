"""The port's other inner solvers (varanneal_tpu_torch/opt/lm.py, tnc.py,
ncg.py), their ladder wiring (anneal/ladder.run_ladder's ``inner=``), the
facade's ``method=`` and the bench's ``BENCH_INNER=lm``, against the JAX
package (varanneal_tpu/opt/lm.py, tnc.py, ncg.py) on the CPU in f64.

Exact counts need the same arithmetic to within what the run forgives.
NCG and LM keep iterates that agree to round-off, and their full solves
are compared exactly. The truncated-Newton solver amplifies round-off
through up to ``cg_iters`` Hessian products an iteration: on the n = 10
Rosenbrock of tests/test_tnc.py the two packages' iterates part at 1e-11
after 10 iterations and 1e-6 after 15, and the full solves end at 132
against 123 iterations (both at the minimum). So TNC's exact comparisons
are a quadratic solved to pgtol (unbounded and in a box), and that
Rosenbrock to maxiter 10.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import varanneal_tpu
from varanneal_tpu.anneal import run_ladder as run_ladder_jax
from varanneal_tpu.kernels import ag_pallas, fe_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax
from varanneal_tpu.opt import lm as lm_jax
from varanneal_tpu.opt import ncg as ncg_jax
from varanneal_tpu.opt import tnc as tnc_jax
from varanneal_tpu.parallel import random_ensemble_inits

from varanneal_tpu_torch import api, bench
from varanneal_tpu_torch.anneal import run_ladder, run_ladder_checkpointed
from varanneal_tpu_torch.kernels import ag
from varanneal_tpu_torch.kernels.fe import make_action_pallas
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, make_action
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.opt.lm import LMOptions, lm_minimize, \
    make_residual_fn
from varanneal_tpu_torch.opt.ncg import NCGOptions, ncg_minimize
from varanneal_tpu_torch.opt.tnc import TNCOptions, autograd_hvp, \
    tnc_minimize
from tests.test_ladder_integration import make_twin

CPU = dict(device="cpu")
D_F, N_F, LIDX_F = 5, 21, (0, 1, 3)     # the Lorenz-96 twin's shape
RF0_L = 1.0


def _vag(fun):
    """value_and_grad of a batched torch objective, by autograd."""
    def vag(x):
        with torch.enable_grad():
            z = x.detach().requires_grad_(True)
            f = fun(z)
            (g,) = torch.autograd.grad(f.sum(), z)
        return f.detach(), g
    return vag


def _rosen_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen(x):
    return torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                     + (1.0 - x[..., :-1]) ** 2, dim=-1)


def _quad(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    Q = M @ M.T + n * np.eye(n)
    b = scale * rng.normal(size=n)
    Qt, bt = torch.tensor(Q), torch.tensor(b)

    def fj(x):
        return 0.5 * x @ (jnp.asarray(Q) @ x) - jnp.asarray(b) @ x

    def ft(x):
        return 0.5 * torch.sum(x * (x @ Qt.T), -1) - torch.sum(x * bt, -1)
    return fj, ft, np.linalg.solve(Q, b)


def _same(rt, rj, xtol=1e-10):
    for k in ("niter", "nfev", "status"):
        assert int(getattr(rt, k)) == int(getattr(rj, k)), (
            k, int(getattr(rt, k)), int(getattr(rj, k)))
    x_j = np.asarray(rj.x)
    scale = max(np.abs(x_j).max(), 1.0)
    assert np.abs(rt.x.numpy() - x_j).max() <= xtol * scale


# ---- NCG -------------------------------------------------------------------

@pytest.mark.parametrize("problem", ["rosenbrock", "quadratic"])
def test_ncg_matches_jax(problem):
    """tests/test_ncg.py's problems: Rosenbrock n = 10 from -1.2 to pgtol
    1e-8 (ftol 1e-17), a quadratic n = 30 to pgtol 1e-6: the same niter,
    nfev and status, x to 1e-10, and the minimum reached."""
    if problem == "rosenbrock":
        fj, ft, x0 = _rosen_jax, _rosen, np.full(10, -1.2)
        kw, xstar = dict(maxiter=5000, pgtol=1e-8, ftol=1e-17), 1.0
    else:
        fj, ft, xstar = _quad(0, 30)
        x0, kw = np.zeros(30), dict(maxiter=500, pgtol=1e-6)
    rj = ncg_jax.ncg_minimize(jax.value_and_grad(fj), jnp.asarray(x0),
                              opts=ncg_jax.NCGOptions(**kw))
    rt = ncg_minimize(_vag(ft), torch.tensor(x0), opts=NCGOptions(**kw),
                      **CPU)
    _same(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), xstar, atol=1e-5)


def test_ncg_batch_freezes_ended_members():
    """Three members of different lengths in one batch: each member's
    records are its own solve's, bit for bit."""
    x0 = np.stack([np.full(6, -1.2), np.full(6, 0.9), np.linspace(-1, 1, 6)])
    kw = dict(maxiter=300, pgtol=1e-7)
    rb = ncg_minimize(_vag(_rosen), torch.tensor(x0), opts=NCGOptions(**kw),
                      **CPU)
    assert len(set(rb.niter.tolist())) > 1
    for i in range(3):
        r1 = ncg_minimize(_vag(_rosen), torch.tensor(x0[i]),
                          opts=NCGOptions(**kw), **CPU)
        for k in ("x", "f", "niter", "nfev", "status"):
            np.testing.assert_array_equal(getattr(r1, k).numpy(),
                                          getattr(rb, k)[i].numpy())


# ---- TNC -------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,bounded", [(0, 30, False), (1, 8, False),
                                            (0, 12, True), (1, 12, True)])
def test_tnc_quadratic_matches_jax(seed, n, bounded):
    """A convex quadratic (tests/test_tnc.py's pattern; in the box [-1, 1],
    with b 40·N(0, 1), its minimum sits on faces) to pgtol 1e-5: the same
    niter, nfev and status, x to 1e-10."""
    fj, ft, _ = _quad(seed, n, 40.0 if bounded else 10.0)
    kw = dict(maxiter=100, cg_iters=n + 5, pgtol=1e-5, ftol=0.0)
    bj, bt = {}, {}
    if bounded:
        bj = dict(lower=-jnp.ones(n), upper=jnp.ones(n))
        bt = dict(lower=-torch.ones(n, dtype=torch.float64),
                  upper=torch.ones(n, dtype=torch.float64))
    rj = tnc_jax.tnc_minimize(jax.value_and_grad(fj), jnp.zeros(n),
                              opts=tnc_jax.TNCOptions(**kw), **bj)
    rt = tnc_minimize(_vag(ft), torch.zeros(n, dtype=torch.float64),
                      hvp=autograd_hvp(ft), opts=TNCOptions(**kw), **bt,
                      **CPU)
    _same(rt, rj)
    assert int(rt.status) == 0
    if bounded:
        assert np.all(np.abs(rt.x.numpy()) <= 1.0)
        assert np.any(np.abs(rt.x.numpy()) == 1.0)


def test_tnc_rosenbrock_matches_jax():
    """tests/test_tnc.py's Rosenbrock (n = 10 from -1.2, cg_iters 50) to
    maxiter 10: the same counts and status, x to 1e-10; run on, the port
    reaches the minimum."""
    x0 = np.full(10, -1.2)
    kw = dict(maxiter=10, cg_iters=50, pgtol=1e-9, ftol=1e-18)
    rj = tnc_jax.tnc_minimize(jax.value_and_grad(_rosen_jax),
                              jnp.asarray(x0), opts=tnc_jax.TNCOptions(**kw))
    rt = tnc_minimize(_vag(_rosen), torch.tensor(x0),
                      hvp=autograd_hvp(_rosen), opts=TNCOptions(**kw), **CPU)
    _same(rt, rj)
    full = tnc_minimize(_vag(_rosen), torch.tensor(x0),
                        hvp=autograd_hvp(_rosen),
                        opts=TNCOptions(**dict(kw, maxiter=500)), **CPU)
    np.testing.assert_allclose(full.x.numpy(), 1.0, atol=1e-6)


def test_tnc_batch_freezes_ended_members():
    """Members with different CG and outer lengths in one batch: each
    member's records are its own solve's, to round-off of the batched
    products (x to 1e-12), its counts exactly."""
    x0 = np.stack([np.full(6, -1.2), np.full(6, 0.9), np.linspace(-1, 1, 6)])
    kw = dict(maxiter=8, cg_iters=20, pgtol=1e-7)
    rb = tnc_minimize(_vag(_rosen), torch.tensor(x0),
                      hvp=autograd_hvp(_rosen), opts=TNCOptions(**kw), **CPU)
    for i in range(3):
        r1 = tnc_minimize(_vag(_rosen), torch.tensor(x0[i]),
                          hvp=autograd_hvp(_rosen), opts=TNCOptions(**kw),
                          **CPU)
        for k in ("niter", "nfev", "status"):
            assert int(getattr(r1, k)) == int(getattr(rb, k)[i])
        np.testing.assert_allclose(r1.x.numpy(), rb.x[i].numpy(),
                                   rtol=0, atol=1e-12)


# ---- LM --------------------------------------------------------------------

def _spec_pair(disc="trapezoid", rm_kind="scalar", seed=0, N_data=21, D=6):
    """tests/test_lm.py's _spec in both packages."""
    rng = np.random.default_rng(seed)
    t = 0.025 * np.arange(N_data)
    Y = rng.normal(size=(N_data, 3))
    if rm_kind == "scalar":
        RM = 4.0
    elif rm_kind == "diag":
        RM = rng.uniform(1, 3, (N_data, 3))
    else:
        Mm = rng.normal(size=(N_data, 3, 3))
        RM = Mm @ np.swapaxes(Mm, 1, 2) + 3 * np.eye(3)
    kw = dict(disc=disc, P=np.array([8.0]), pidx=[0])
    return (build_spec_jax(lorenz96_jax, D, Y, t, [0, 2, 4], RM, **kw),
            build_spec(lorenz96, D, Y, t, [0, 2, 4], RM, **kw), rng)


@pytest.mark.parametrize("rm_kind", ["scalar", "diag", "matrix"])
@pytest.mark.parametrize("disc", ["euler", "trapezoid", "SimpsonHermite",
                                  "forwardmap"])
def test_residual_norm_equals_action(disc, rm_kind):
    """‖r(XP, rf)‖² equals the port's action to 1e-12 over the R zoo: RM
    scalar, (N, L) and (N, L, L); rf scalar, (N_f-1, D) and, with a matrix
    RM, (N_f-1, D, D); batched (B = 2); and r equals the JAX package's
    make_residual_fn to 1e-12 of its largest entry."""
    sj, st, rng = _spec_pair(disc, rm_kind)
    res_t = make_residual_fn(st, **CPU)
    res_j = lm_jax.make_residual_fn(sj)
    act, _ = make_action(st, **CPU)
    XP = rng.normal(size=(2, st.n_dof))
    rfs = [3e-3, rng.uniform(0.5, 2.0, (st.N_f - 1, st.D))]
    if rm_kind == "matrix":
        Mm = rng.normal(size=(st.N_f - 1, st.D, st.D))
        rfs.append(1e-3 * (Mm @ np.swapaxes(Mm, 1, 2)
                           + st.D * np.eye(st.D)))
    for rf in rfs:
        rf_t = rf if np.ndim(rf) == 0 else torch.tensor(rf)
        r = res_t(torch.tensor(XP), rf_t)
        A = act(torch.tensor(XP), rf_t)
        np.testing.assert_allclose(torch.sum(r * r, -1).numpy(), A.numpy(),
                                   rtol=1e-12)
        r_j = np.asarray(res_j(jnp.asarray(XP[0]), jnp.asarray(rf)))
        assert np.abs(r[0].numpy() - r_j).max() <= 1e-12 * np.abs(r_j).max()


def test_lm_rosenbrock_and_bounds_match_jax():
    """tests/test_lm.py's Rosenbrock least squares (n = 8) and its bounded
    case: the same niter, nfev and status, x to 1e-10."""
    def res_j(x):
        return jnp.concatenate([10.0 * (x[1:] - x[:-1] ** 2), 1.0 - x[:-1]])

    def res_t(x):
        return torch.cat([10.0 * (x[..., 1:] - x[..., :-1] ** 2),
                          1.0 - x[..., :-1]], dim=-1)
    kw = dict(maxiter=200, pgtol=1e-10, cg_iters=30, ftol=1e-16)
    rj = lm_jax.lm_minimize(res_j, jnp.full(8, -1.2),
                            opts=lm_jax.LMOptions(**kw))
    rt = lm_minimize(res_t, torch.full((8,), -1.2, dtype=torch.float64),
                     opts=LMOptions(**kw), **CPU)
    _same(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), 1.0, atol=1e-8)
    c = np.array([2.0, -3.0, 0.5])
    rj = lm_jax.lm_minimize(lambda x: x - jnp.asarray(c), jnp.zeros(3),
                            lower=-jnp.ones(3), upper=jnp.ones(3),
                            opts=lm_jax.LMOptions(maxiter=100, pgtol=1e-12))
    rt = lm_minimize(lambda x: x - torch.tensor(c), torch.zeros(
        3, dtype=torch.float64), lower=-np.ones(3), upper=np.ones(3),
        opts=LMOptions(maxiter=100, pgtol=1e-12), **CPU)
    _same(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), [1.0, -1.0, 0.5], atol=1e-8)


# ---- ladders ---------------------------------------------------------------

def _twin_pair():
    """A Lorenz-96 twin in both packages (D = 5, N = 21, 3 observed, F
    estimated): a landscape whose rungs have one minimizer near the
    truth."""
    traj, Y, t, rng = make_twin(D=D_F, N_data=N_F, Lidx=LIDX_F)
    kw = dict(disc="trapezoid", P=np.array([6.0]), pidx=[0])
    return (build_spec_jax(lorenz96_jax, D_F, Y, t, LIDX_F, 6.25, **kw),
            build_spec(lorenz96, D_F, Y, t, LIDX_F, 6.25, **kw), traj, rng)


def _twin_start(traj, rng):
    """The twin's truth with N(0, 0.5) noise, F at 6."""
    return np.concatenate([
        (traj + 0.5 * rng.normal(size=traj.shape)).ravel(), [6.0]])


def _ladders(inner, betas, n_members=1, opts=None, lm=None):
    """The twin's ladder from ``n_members`` copies of a noisy truth (rf0
    RF0_L, alpha 1.9) through each package's run_ladder with
    ``inner``; ``lm``: LMOptions' fields."""
    sj, st, traj, rng = _twin_pair()
    xp0 = np.stack([_twin_start(traj, rng)] * n_members)
    act_j, parts_j = make_action_jax(sj)
    act_t, parts_t = make_action(st, **CPU)
    opts = opts or dict(maxiter=2000, pgtol=1e-9, ftol=0.0)
    ex_j, ex_t = {}, {}
    if inner == "lm":
        ex_j = dict(residual_fn=lm_jax.make_residual_fn(sj),
                    lm_opts=lm_jax.LMOptions(**lm))
        ex_t = dict(residual_fn=make_residual_fn(st, **CPU),
                    lm_opts=LMOptions(**lm))
    rj = jax.jit(jax.vmap(lambda z: run_ladder_jax(
        act_j, parts_j, z, jnp.asarray(betas), RF0_L, 1.9, inner=inner,
        opts=OptsJax(**opts), store_paths=False, **ex_j)))(
        jnp.asarray(xp0))
    rt = run_ladder(act_t, parts_t, torch.tensor(xp0), betas, RF0_L, 1.9,
                    inner=inner, opts=LBFGSOptions(**opts),
                    store_paths=False, **ex_t, **CPU)
    return rj, rt


def _converged_match(rj, rt, tol=1e-8):
    """A within ``tol`` at the rungs where both packages ended on pgtol
    (status 0: ftol stops end at points that move beyond 1e-8 under
    rounding alone), at least half of them."""
    A_j, A_t = np.asarray(rj.A), rt.A.numpy()
    both = (np.asarray(rj.status) == 0) & (rt.status.numpy() == 0)
    assert both.sum() >= max(1, both.size // 2), both
    rel = np.abs(A_t - A_j) / np.abs(A_j)
    assert rel[both].max() <= tol, rel


@pytest.mark.parametrize("inner", ["tnc", "ncg"])
def test_l96_ladder_matches_jax(inner):
    """A Lorenz-96 twin ladder (D = 5, N = 21, f64, rf0 1, alpha 1.9;
    TNC rungs β 3..5, NCG β 3..4) through TNC and NCG in both packages:
    every rung ends on pgtol 1e-7 (ftol off) in both, A within 1e-8
    (measured from β 0: 5e-10 TNC, 2e-10 NCG, their iterates parting from
    round-off: TNC's niter 182/60/48 against 148/54/52)."""
    betas = 3.0 + np.arange(3.0 if inner == "tnc" else 2.0)
    rj, rt = _ladders(inner, betas,
                      opts=dict(maxiter=2000, pgtol=1e-7, ftol=0.0))
    assert (rt.status.numpy() == 0).all()
    _converged_match(rj, rt)


def test_lm_ladder_matches_jax_and_lbfgs():
    """tests/test_lm.py::test_lm_ladder_matches_lbfgs_ladder's counterpart
    on the twin (3 rungs, LM maxiter 100, cg_iters 25, pgtol 1e-9, ftol
    off): the same niter and nfev as the JAX package's LM ladder and A
    within 1e-8 (measured: 2e-16) at the rungs where both ended on pgtol,
    and at least as low as the port's L-BFGS ladder (2 %), within 20 %."""
    betas = np.arange(3.0)
    rj, rt = _ladders("lm", betas, lm=dict(maxiter=100, cg_iters=25,
                                           pgtol=1e-9, ftol=0.0))
    _converged_match(rj, rt)
    for k in ("niter", "nfev", "status"):
        np.testing.assert_array_equal(getattr(rt, k).numpy(),
                                      np.asarray(getattr(rj, k)))
    _, st, traj, rng = _twin_pair()
    act, parts = make_action(st, **CPU)
    rl = run_ladder(act, parts, torch.tensor(_twin_start(traj, rng)), betas,
                    RF0_L, 1.9, opts=LBFGSOptions(maxiter=2000, pgtol=1e-9),
                    store_paths=False, **CPU)
    A_lm, A_lb = rt.A.numpy()[0], rl.A.numpy()
    assert np.all(A_lm <= A_lb * 1.02), (A_lm, A_lb)
    assert np.all(np.abs(A_lm - A_lb) / A_lb < 0.2)
    assert int(rt.nfev.sum()) > 0


def test_ladder_inner_checks():
    """run_ladder's checks (the reference's): LM needs residual_fn, NCG
    takes no bounds, an unknown solver raises, TNC refuses K6's action
    (its records have no second derivative) and over K1's takes the
    curvature from the records action; run_ladder_checkpointed forwards
    inner."""
    _, st, rng = _spec_pair()
    act, parts = make_action(st, **CPU)
    xp = torch.tensor(random_ensemble_inits(st, 1, seed=4)[0])
    b = np.arange(2.0)
    with pytest.raises(ValueError, match="residual_fn"):
        run_ladder(act, parts, xp, b, 1e-3, 1.8, inner="lm", **CPU)
    with pytest.raises(ValueError, match="bounds"):
        run_ladder(act, parts, xp, b, 1e-3, 1.8, inner="ncg",
                   lower=-np.ones(st.n_dof) * 20, **CPU)
    with pytest.raises(ValueError, match="unknown"):
        run_ladder(act, parts, xp, b, 1e-3, 1.8, inner="bfgs", **CPU)
    act_p, parts_p = make_action_pallas(st, **CPU)
    with pytest.raises(ValueError, match="second derivative"):
        run_ladder(act_p, parts_p, xp, b, 1e-3, 1.8, inner="tnc", **CPU)
    act_k, parts_k = ag.make_action_ag(st, dtype=torch.float64, **CPU)
    kw = dict(opts=LBFGSOptions(maxiter=30, pgtol=1e-8), store_paths=False,
              **CPU)
    r1 = run_ladder(act_k, parts_k, xp, b, 1e-3, 1.8, inner="tnc", **kw)
    r2 = run_ladder_checkpointed(act_k, parts_k, xp, b, 1e-3, 1.8,
                                 save_every=1, inner="tnc", **kw)
    np.testing.assert_array_equal(r1.A.numpy(), r2.A.numpy())
    np.testing.assert_array_equal(r1.nfev.numpy(), r2.nfev.numpy())


# ---- the facade and the bench ----------------------------------------------

def _facade(pkg, method, engine="auto", **kw):
    """One package's facade (``pkg`` 'jax' or 'port') on rung β 3 of the
    Lorenz-96 twin, f64, pgtol 1e-7, ftol off; ``kw`` overrides."""
    traj, Y, t, rng = make_twin(D=D_F, N_data=N_F, Lidx=LIDX_F)
    X0 = traj + 0.5 * rng.normal(size=traj.shape)
    args = dict(P0=np.array([6.0]), alpha=1.9, beta_array=[3],
                RM=6.25, RF0=RF0_L, Lidx=list(LIDX_F), Pidx=[0],
                dtype=np.float64, method=method, engine=engine,
                opt_args=dict(maxiter=2000, gtol=1e-7, ftol=0.0))
    args.update(kw)
    mod, f, ctor = ((varanneal_tpu, lorenz96_jax, {}) if pkg == "jax"
                    else (api, lorenz96, CPU))
    ann = mod.Annealer(**ctor)
    ann.set_model(f, D_F)
    ann.set_data(Y, t=t)
    ann.anneal(X0, **args)
    return ann


def _facades(method, engine="auto", **kw):
    return tuple(_facade(pkg, method, engine, **kw)
                 for pkg in ("jax", "port"))


@pytest.mark.parametrize("method,extra", [
    ("LM", dict(opt_args=dict(maxiter=100, gtol=1e-9, ftol=0.0,
                              cg_iters=25))),
    ("TNC", dict(bounds=[(-1.5, 7.5)] * 5 + [(3.0, 7.5)])), ("CG", {})])
def test_facade_methods_match_jax(method, extra):
    """The facade's method= through both packages on rung β 3 of the
    Lorenz-96 twin (f64, rf0 1, pgtol 1e-7 or, for LM, 1e-9 with
    cg_iters 25, ftol off; TNC in the box of tests/test_torch_api.py):
    converged in both, A within 1e-8, records of the reference's shapes,
    the box held."""
    aj, ap = _facades(method, **extra)
    assert ap.A_array.shape == (1,) and ap.minpaths.shape == (
        1, ap.spec.n_dof)
    assert (ap.exitflags == 0).all() and (aj.exitflags == 0).all(), (
        aj.exitflags, ap.exitflags)
    rel = np.abs(ap.A_array - aj.A_array) / np.abs(aj.A_array)
    assert rel.max() <= 1e-8, rel
    if "bounds" in extra:
        lo, hi = api.build_bounds(ap.spec, extra["bounds"], np.float64)
        assert np.all(ap.minpaths >= lo) and np.all(ap.minpaths <= hi)


@pytest.mark.parametrize("alias,method", [("GN", "LM"), ("NCG", "CG")])
def test_facade_method_aliases(alias, method):
    """'GN' is 'LM' and 'NCG' is 'CG', as in the reference: the same
    records bit for bit (three iterations of rung β 3)."""
    traj, Y, t, rng = make_twin(D=D_F, N_data=N_F, Lidx=LIDX_F)
    X0 = traj + 0.5 * rng.normal(size=traj.shape)
    recs = []
    for m in (alias, method):
        ann = api.Annealer(**CPU)
        ann.set_model(lorenz96, D_F)
        ann.set_data(Y, t=t)
        ann.anneal(X0, np.array([6.0]), 1.9, [3], 6.25, RF0_L,
                   list(LIDX_F), [0], method=m, dtype=np.float64,
                   opt_args=dict(maxiter=3, cg_iters=10))
        recs.append((ann.A_array, ann.nfev_array, ann.minpaths))
    for a, b in zip(*recs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_facade_tnc_engines(dtype):
    """method='TNC' over each engine, in both packages (the reference's
    kernels in interpret mode). Over K6 ('pallas') both fail: the
    reference in JAX's forward-mode rule of ``pallas_call``
    (AssertionError from ``pallas/core.py``'s ``axis_frame``), the port
    with ValueError. Over K1 ('ag') the reference differentiates its
    kernel itself, forward over reverse through its custom_vjp, and only
    in f32 (its K1 refuses f64); the port's K1 has no second derivative,
    so its TNC takes the curvature from the records action, the autograd
    action of the same problem. In f64 the port's TNC over 'ag' is held
    to the reference's over 'xla' and to its own over 'xla' at 1e-8. In
    f32 both packages' TNC over 'ag' end converged, each within 5e-5 of
    the f64 minimum: with ftol 0, f32 runs stop on a step that leaves f
    unchanged, here at a projected gradient of ~2e-5 and A up to 1.1e-5
    above that minimum (measured: the port 1.07e-5, the reference
    1e-7), so the two are not held to each other more tightly."""
    kw = dict(dtype=dtype)
    ag_pallas.set_interpret(True)
    fe_pallas.set_interpret(True)
    try:
        with pytest.raises(AssertionError):
            _facade("jax", "TNC", "pallas", **kw)
        with pytest.raises(ValueError, match="second derivative"):
            _facade("port", "TNC", "pallas", **kw)
        runs = [_facade("port", "TNC", "ag", **kw)]
        if dtype == np.float64:
            with pytest.raises(ValueError, match="engine='ag' unsupported"):
                _facade("jax", "TNC", "ag", **kw)
            ref = _facade("jax", "TNC", "xla", **kw).A_array
            runs.append(_facade("port", "TNC", "xla", **kw))
            tol = 1e-8
        else:
            runs.append(_facade("jax", "TNC", "ag", **kw))
            ref = _facade("jax", "TNC", "xla").A_array
            tol = 5e-5
    finally:
        ag_pallas.set_interpret(False)
        fe_pallas.set_interpret(False)
    for run in runs:
        assert (run.exitflags == 0).all(), run.exitflags
        np.testing.assert_allclose(run.A_array, ref, rtol=tol)


def test_bench_inner_lm():
    """BENCH_INNER=lm under BENCH_SOLVER=xla: the port's bench runs the
    ladder on the LM solver (maxiter // 10 a rung), records (1, 3) and
    finite, the same records as run_ladder with inner='lm' on the bench's
    problem."""
    env = dict(BENCH_NBETA="3", BENCH_MAXITER="50", BENCH_TAIL64="0",
               BENCH_INNER="lm", BENCH_SOLVER="xla", BENCH_DTYPE="f64")
    run = bench.main(device="cpu", env=env)
    assert tuple(run.res.A.shape) == (1, 3)
    assert np.isfinite(run.out["value"])
    assert bool(torch.all(run.res.niter <= 5))
    assert bool(torch.all(run.res.nfev == 1 + run.res.niter * 22))
