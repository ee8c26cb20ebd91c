"""The port's batched L-BFGS (varanneal_tpu_torch/opt/lbfgs.py) against the
JAX solver (varanneal_tpu/opt/lbfgs.py) in f64: per member the same niter,
nfev and status, and x to 1e-8, on Rosenbrock and on the Lorenz-96 action.
Members that end early stay frozen while the others run on."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax
from varanneal_tpu.opt import lbfgs_minimize as lbfgs_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax

from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, make_action, value_and_grad
from varanneal_tpu_torch.opt import lbfgs_minimize, LBFGSOptions
from tests.test_ladder_integration import make_twin


def _rosen_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen_vag_torch(x):
    with torch.enable_grad():
        z = x.detach().requires_grad_(True)
        f = torch.sum(100.0 * (z[:, 1:] - z[:, :-1] ** 2) ** 2
                      + (1.0 - z[:, :-1]) ** 2, dim=-1)
        (g,) = torch.autograd.grad(f.sum(), z)
    return f.detach(), g


def _jax_batched(vag, X0, opts):
    run = jax.jit(jax.vmap(lambda x0: lbfgs_jax(vag, x0, opts=opts)))
    r = run(jnp.asarray(X0))
    return {k: np.asarray(getattr(r, k))
            for k in ("x", "f", "niter", "nfev", "status")}


def _assert_same(rt, rj, xtol=1e-8):
    np.testing.assert_array_equal(rt.niter.numpy(), rj["niter"])
    np.testing.assert_array_equal(rt.nfev.numpy(), rj["nfev"])
    np.testing.assert_array_equal(rt.status.numpy(), rj["status"])
    scale = np.maximum(np.abs(rj["x"]).max(axis=1, keepdims=True), 1.0)
    np.testing.assert_allclose(rt.x.numpy() / scale, rj["x"] / scale,
                               rtol=0, atol=xtol)
    np.testing.assert_allclose(rt.f.numpy(), rj["f"], rtol=1e-10,
                               atol=1e-14)


@pytest.mark.parametrize("direction", ["compact", "two_loop"])
def test_rosenbrock_matches_jax(direction):
    rng = np.random.default_rng(0)
    X0 = rng.uniform(-1.5, 1.5, (3, 6))
    kw = dict(m=5, maxiter=400, pgtol=1e-9, ftol=1e-14,
              direction=direction)
    rj = _jax_batched(jax.value_and_grad(_rosen_jax), X0, OptsJax(**kw))
    rt = lbfgs_minimize(_rosen_vag_torch, torch.tensor(X0),
                        opts=LBFGSOptions(**kw), device="cpu")
    _assert_same(rt, rj)
    assert (rt.status.numpy() <= 1).all()


def _l96_pair():
    D, N_data, Lidx = 5, 21, (0, 1, 3)
    traj, Y, t, rng = make_twin(D=D, N_data=N_data, Lidx=Lidx)
    kw = dict(disc="trapezoid", P=np.array([4.0]), pidx=[0])
    spec_j = build_spec_jax(lorenz96_jax, D, Y, t, Lidx, 6.25, **kw)
    spec_t = build_spec(lorenz96, D, Y, t, Lidx, 6.25, **kw)
    X0 = np.empty((3, spec_t.n_dof))
    X0[:, :-1] = (traj[None] + 0.3 * rng.normal(size=(3,) + traj.shape)
                  ).reshape(3, -1)
    X0[:, -1] = 8.17 + 0.5 * rng.normal(size=3)
    return spec_j, spec_t, X0


def test_l96_action_matches_jax():
    """The first 60 iterations on the Lorenz-96 action, each package with
    its own f64 action. The two actions round their sums differently
    (~1e-16 relative), and on this landscape the iterates' difference
    grows by orders of magnitude over a hundred iterations until a line
    search takes another branch. So full solves are compared on Rosenbrock
    above and through the ladder tests, and this one stops at maxiter,
    where every count must still agree exactly and x to 1e-8."""
    spec_j, spec_t, X0 = _l96_pair()
    rf = 10.0
    kw = dict(m=5, maxiter=60, pgtol=1e-8, ftol=2.22e-9)
    act_j, _ = make_action_jax(spec_j)
    rj = _jax_batched(jax.value_and_grad(lambda z: act_j(z, rf)), X0,
                      OptsJax(**kw))
    act_t, _ = make_action(spec_t, device="cpu")
    vag = value_and_grad(act_t)
    rt = lbfgs_minimize(lambda z: vag(z, rf), torch.tensor(X0),
                        opts=LBFGSOptions(**kw), device="cpu")
    _assert_same(rt, rj)
    assert (rt.status.numpy() == 2).all()


def test_ended_members_stay_frozen():
    """A member converged at its start and members that end at different
    iterations give, in one batch, exactly what each gives alone."""
    rng = np.random.default_rng(4)
    X0 = rng.uniform(-1.5, 1.5, (3, 6))
    X0[1] = 1.0                                   # the minimizer: pg = 0
    opts = LBFGSOptions(m=5, maxiter=400, pgtol=1e-9, ftol=1e-14)
    rb = lbfgs_minimize(_rosen_vag_torch, torch.tensor(X0), opts=opts,
                        device="cpu")
    assert int(rb.niter[1]) == 0 and int(rb.nfev[1]) == 1
    assert int(rb.status[1]) == 0
    np.testing.assert_array_equal(rb.x[1].numpy(), X0[1])
    assert len(set(rb.niter.tolist())) == 3        # three different ends
    for b in range(3):
        r1 = lbfgs_minimize(_rosen_vag_torch, torch.tensor(X0[b]),
                            opts=opts, device="cpu")
        assert int(r1.niter) == int(rb.niter[b])
        assert int(r1.nfev) == int(rb.nfev[b])
        assert int(r1.status) == int(rb.status[b])
        np.testing.assert_array_equal(r1.x.numpy(), rb.x[b].numpy())


def test_waiting_paths_raise():
    """With bounds, bounded_algo='subspace' runs the subspace L-BFGS-B
    (opt/lbfgsb.py; it raised until that module was ported); an unknown
    direction or bounded_algo is refused."""
    x0 = torch.zeros(2, 3, dtype=torch.float64)
    res = lbfgs_minimize(_rosen_vag_torch, x0, lower=-torch.ones(3),
                         device="cpu",
                         opts=LBFGSOptions(bounded_algo="subspace"))
    assert res.x.shape == (2, 3) and bool(torch.all(res.x >= -1.0))
    assert bool(torch.all(res.niter > 0))
    with pytest.raises(ValueError):
        lbfgs_minimize(_rosen_vag_torch, x0, device="cpu",
                       opts=LBFGSOptions(direction="qr"))
    with pytest.raises(ValueError):
        lbfgs_minimize(_rosen_vag_torch, x0, device="cpu",
                       opts=LBFGSOptions(bounded_algo="box"))
