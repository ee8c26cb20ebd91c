"""The port's subspace L-BFGS-B (varanneal_tpu_torch/opt/lbfgsb.py) against
the JAX package's (varanneal_tpu/opt/lbfgsb.py) on the cases of
tests/test_lbfgsb.py, in f64 on the CPU: the compact matrices, the
generalized Cauchy point and the subspace step equal the JAX functions'
to 1e-12 on the same history and hold their own identities (BNS compact
Hessian, a brute-force GCP, the dense projected Newton step); whole
solves match SciPy's Fortran L-BFGS-B as the JAX solver does, and the
JAX solver iterate for iterate (counts exact, x within 1e-10) while
termination is not decided by round-off; the batched solve matches the
JAX solver vmapped over the same members."""

import numpy as np
import jax
import jax.numpy as jnp
import torch
from scipy.optimize import minimize as sp_minimize

from varanneal_tpu.opt import LBFGSOptions as OptsJax
from varanneal_tpu.opt import lbfgs_minimize as lbfgs_minimize_jax
from varanneal_tpu.opt import lbfgsb as lbfgsb_jax

from varanneal_tpu_torch.opt import LBFGSOptions, lbfgs_minimize
from varanneal_tpu_torch.opt.lbfgsb import (
    _cauchy_point, _compact_matrices, _dense_inv, _subspace_step,
    lbfgsb_minimize)

CPU = dict(device="cpu")


def _history(rng, m, n):
    S = rng.normal(size=(m, n))
    Yh = rng.normal(size=(m, n))
    for i in range(m):                    # sy > 0 for every pair
        if S[i] @ Yh[i] <= 0:
            Yh[i] = -Yh[i]
    return S, Yh


def _both_compact(S, Yh, m, head=0, hlen=None):
    hlen = m if hlen is None else hlen
    tj = lbfgsb_jax._compact_matrices(
        jnp.asarray(S), jnp.asarray(Yh), jnp.asarray(head, jnp.int32),
        jnp.asarray(hlen, jnp.int32), m, jnp.float64)
    tt = _compact_matrices(torch.tensor(S)[None], torch.tensor(Yh)[None],
                           torch.tensor([head]), torch.tensor([hlen]), m,
                           torch.float64)
    return tj, tt


def _dense_B(theta, Wt, Minv, n):
    return theta * np.eye(n) - Wt.T @ np.linalg.inv(Minv) @ Wt


def _box_case(seed):
    rng = np.random.default_rng(seed)
    n, m = 12, 4
    S, Yh = _history(rng, m, n)
    (th_j, Wt_j, Mi_j), (th, Wt, Mi) = _both_compact(S, Yh, m)
    x = rng.normal(size=n)
    g = rng.normal(size=n)
    lo = x - rng.uniform(0.05, 2.0, n)
    hi = x + rng.uniform(0.05, 2.0, n)
    return (n, m, x, g, lo, hi, (th_j, Wt_j, Mi_j), (th, Wt, Mi))


def test_compact_matrices_identities():
    rng = np.random.default_rng(0)
    n, m = 12, 4
    S, Yh = _history(rng, m, n)
    for head, hlen in ((0, m), (3, 2)):
        (th_j, Wt_j, Mi_j), (th, Wt, Mi) = _both_compact(S, Yh, m, head,
                                                         hlen)
        np.testing.assert_allclose(th.numpy()[0], float(th_j), rtol=1e-12)
        np.testing.assert_allclose(Wt.numpy()[0], np.asarray(Wt_j),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(Mi.numpy()[0], np.asarray(Mi_j),
                                   rtol=1e-12, atol=1e-14)
    (_, _, _), (th, Wt, Mi) = _both_compact(S, Yh, m)
    th, Wt, Mi = float(th[0]), Wt[0].numpy(), Mi[0].numpy()
    B = _dense_B(th, Wt, Mi, n)
    assert np.allclose(B, B.T)
    assert np.all(np.linalg.eigvalsh(B) > 0)
    np.testing.assert_allclose(B @ S[m - 1], Yh[m - 1], atol=1e-8)
    assert np.isclose(th, (Yh[m - 1] @ Yh[m - 1]) / (S[m - 1] @ Yh[m - 1]))
    # the Gauss–Jordan inverse is an inverse
    np.testing.assert_allclose(_dense_inv(torch.tensor(Mi)[None])[0].numpy()
                               @ Mi, np.eye(2 * m), atol=1e-10)


def test_cauchy_point_matches_jax_and_brute_force():
    n, m, x, g, lo, hi, cj, ct = _box_case(1)
    x_cp_j, free_j = lbfgsb_jax._cauchy_point(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(lo), jnp.asarray(hi),
        *cj, jnp.float64)
    x_cp, free = _cauchy_point(
        torch.tensor(x)[None], torch.tensor(g)[None], torch.tensor(lo)[None],
        torch.tensor(hi)[None], *ct, torch.float64)
    x_cp, free = x_cp[0].numpy(), free[0].numpy()
    np.testing.assert_allclose(x_cp, np.asarray(x_cp_j), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal(free, np.asarray(free_j))
    B = _dense_B(float(ct[0][0]), ct[1][0].numpy(), ct[2][0].numpy(), n)

    def model(u):
        return g @ u + 0.5 * u @ B @ u

    tgrid = np.linspace(0.0, 5.0, 20001)
    mv = np.array([model(np.clip(x - t * g, lo, hi) - x) for t in tgrid])
    assert model(x_cp - x) <= mv.min() + 1e-3
    assert np.all((x_cp[~free] <= lo[~free] + 1e-12)
                  | (x_cp[~free] >= hi[~free] - 1e-12))


def test_subspace_step_matches_jax_and_dense_projection():
    n, m, x, g, lo, hi, cj, ct = _box_case(2)
    t = [torch.tensor(v)[None] for v in (x, g, lo, hi)]
    x_cp, free = _cauchy_point(*t, *ct, torch.float64)
    x_bar = _subspace_step(t[0], t[1], x_cp, free, t[2], t[3], *ct,
                           torch.float64)[0].numpy()
    xj_cp, free_j = lbfgsb_jax._cauchy_point(
        *(jnp.asarray(v) for v in (x, g, lo, hi)), *cj, jnp.float64)
    x_bar_j = np.asarray(lbfgsb_jax._subspace_step(
        jnp.asarray(x), jnp.asarray(g), xj_cp, free_j, jnp.asarray(lo),
        jnp.asarray(hi), *cj, jnp.float64))
    np.testing.assert_allclose(x_bar, x_bar_j, rtol=1e-12, atol=1e-12)
    B = _dense_B(float(ct[0][0]), ct[1][0].numpy(), ct[2][0].numpy(), n)
    x_cp, free = x_cp[0].numpy(), free[0].numpy()
    F = np.where(free)[0]
    r = g + B @ (x_cp - x)
    d = np.zeros(n)
    d[F] = np.linalg.solve(B[np.ix_(F, F)], -r[F])
    np.testing.assert_allclose(x_bar, np.clip(x_cp + d, lo, hi), atol=1e-8)


def _quadratic(seed, n, scale):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    Q = M @ M.T + n * np.eye(n)
    b = scale * rng.normal(size=n)

    def f(x):
        return 0.5 * x @ (Q @ x) - b @ x

    Qt, bt = torch.tensor(Q), torch.tensor(b)

    def vag_t(x):
        Qx = x @ Qt.T
        return 0.5 * torch.sum(x * Qx, dim=-1) - x @ bt, Qx - bt

    return f, jax.value_and_grad(f), vag_t, rng


def _rosen(n):
    def fr(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1.0 - x[:-1]) ** 2)

    def vag_t(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                          + (1.0 - x[..., :-1]) ** 2, dim=-1)
            (g,) = torch.autograd.grad(f.sum(), x)
        return f.detach(), g

    return fr, jax.value_and_grad(fr), vag_t


def _assert_same_solve(rt, rj, xtol=1e-10):
    assert int(rt.niter) == int(rj.niter)
    assert int(rt.nfev) == int(rj.nfev)
    assert int(rt.status) == int(rj.status)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=xtol)


def test_lbfgsb_bounded_quadratic_vs_scipy_and_jax():
    n = 40
    f, vag, vag_t, _ = _quadratic(1, n, 10.0)
    lo, hi = -np.ones(n), np.ones(n)
    opts = dict(maxiter=200, pgtol=1e-10, ftol=1e-18)
    res = lbfgsb_minimize(vag_t, torch.zeros(n, dtype=torch.float64),
                          lower=lo, upper=hi, opts=LBFGSOptions(**opts),
                          **CPU)
    sp = sp_minimize(lambda z: float(f(jnp.asarray(z))), np.zeros(n),
                     jac=lambda z: np.asarray(vag(jnp.asarray(z))[1]),
                     method="L-BFGS-B", bounds=list(zip(lo, hi)),
                     options=dict(maxiter=500, gtol=1e-10, ftol=0.0))
    assert float(res.f) <= sp.fun + 1e-9 * abs(sp.fun)
    np.testing.assert_allclose(res.x.numpy(), sp.x, atol=1e-6)
    assert int(res.niter) <= sp.nit + 10
    # iterate for iterate with the JAX solver, up to where round-off at
    # ftol 1e-18 decides the stop
    opts["maxiter"] = 15
    rt = lbfgsb_minimize(vag_t, torch.zeros(n, dtype=torch.float64),
                         lower=lo, upper=hi, opts=LBFGSOptions(**opts),
                         **CPU)
    rj = lbfgsb_jax.lbfgsb_minimize(vag, jnp.zeros(n), lower=jnp.asarray(lo),
                                    upper=jnp.asarray(hi),
                                    opts=OptsJax(**opts))
    _assert_same_solve(rt, rj)


def test_lbfgsb_bounded_rosenbrock_vs_scipy_and_jax():
    n = 10
    fr, vag, vag_t = _rosen(n)
    lo, hi = np.full(n, -2.0), np.full(n, 0.9)
    opts = dict(maxiter=500, pgtol=1e-9, ftol=1e-18)
    x0 = np.full(n, -1.2)
    res = lbfgsb_minimize(vag_t, torch.tensor(x0), lower=lo, upper=hi,
                          opts=LBFGSOptions(**opts), **CPU)
    sp = sp_minimize(lambda z: float(fr(jnp.asarray(z))), x0,
                     jac=lambda z: np.asarray(vag(jnp.asarray(z))[1]),
                     method="L-BFGS-B", bounds=list(zip(lo, hi)),
                     options=dict(maxiter=2000, gtol=1e-9, ftol=0.0))
    assert abs(float(res.f) - sp.fun) <= 1e-8 * max(1.0, abs(sp.fun))
    x = res.x.numpy()
    assert np.all(x >= lo) and np.all(x <= hi)
    opts["maxiter"] = 25
    rt = lbfgsb_minimize(vag_t, torch.tensor(x0), lower=lo, upper=hi,
                         opts=LBFGSOptions(**opts), **CPU)
    rj = lbfgsb_jax.lbfgsb_minimize(vag, jnp.asarray(x0),
                                    lower=jnp.asarray(lo),
                                    upper=jnp.asarray(hi),
                                    opts=OptsJax(**opts))
    _assert_same_solve(rt, rj)


def test_lbfgsb_dispatch_and_batch():
    """bounded_algo='subspace' with bounds dispatches through
    lbfgs_minimize; a batch of five members each reaches the constrained
    minimum and makes its own single solve's iterations exactly."""
    n = 8
    _, vag, vag_t, rng = _quadratic(4, n, 5.0)
    opts = LBFGSOptions(maxiter=100, pgtol=1e-10, bounded_algo="subspace")
    lo, hi = -np.ones(n), np.ones(n)
    r1 = lbfgs_minimize(vag_t, torch.zeros(n, dtype=torch.float64),
                        lower=lo, upper=hi, opts=opts, **CPU)
    X0 = rng.uniform(-1, 1, size=(5, n))
    rb = lbfgs_minimize(vag_t, torch.tensor(X0), lower=lo, upper=hi,
                        opts=opts, **CPU)
    assert rb.f.shape == (5,)
    np.testing.assert_allclose(rb.f.numpy(), float(r1.f) * np.ones(5),
                               rtol=1e-6)
    for b in range(5):
        rs = lbfgs_minimize(vag_t, torch.tensor(X0[b]), lower=lo, upper=hi,
                            opts=opts, **CPU)
        assert int(rs.niter) == int(rb.niter[b])
        assert int(rs.nfev) == int(rb.nfev[b])


def test_lbfgsb_matches_unbounded_when_bounds_inactive():
    n = 6
    _, _, vag_t = _rosen(n)
    x0 = torch.full((n,), -1.2, dtype=torch.float64)
    opts = LBFGSOptions(maxiter=500, pgtol=1e-10, ftol=1e-18)
    res_u = lbfgs_minimize(vag_t, x0, opts=opts, **CPU)
    res_b = lbfgsb_minimize(vag_t, x0, lower=np.full(n, -100.0),
                            upper=np.full(n, 100.0), opts=opts, **CPU)
    np.testing.assert_allclose(res_b.x.numpy(), res_u.x.numpy(), atol=1e-6)


def test_batched_solve_matches_jax_iterate_for_iterate():
    """Three members of a boxed Rosenbrock (each its own start and box,
    the box binding) through the port's batched solver and the JAX solver
    vmapped: niter, nfev and status exact per member, x within 1e-10."""
    n = 10
    _, vag, vag_t = _rosen(n)
    rng = np.random.default_rng(6)
    X0 = rng.uniform(-1.5, 0.5, size=(3, n))
    lo = np.stack([np.full(n, -2.0), np.full(n, -1.0), np.full(n, -2.0)])
    hi = np.stack([np.full(n, 0.9), np.full(n, 0.7), np.full(n, 1.5)])
    kw = dict(maxiter=40, pgtol=1e-8, ftol=1e-14, m=5,
              bounded_algo="subspace")
    rt = lbfgs_minimize(vag_t, torch.tensor(X0), lower=lo, upper=hi,
                        opts=LBFGSOptions(**kw), **CPU)
    rj = jax.vmap(lambda z, a, b: lbfgs_minimize_jax(
        vag, z, lower=a, upper=b, opts=OptsJax(**kw)))(
            jnp.asarray(X0), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(rt.niter.numpy(), np.asarray(rj.niter))
    np.testing.assert_array_equal(rt.nfev.numpy(), np.asarray(rj.nfev))
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-10)
    assert np.all(rt.x.numpy() >= lo) and np.all(rt.x.numpy() <= hi)
