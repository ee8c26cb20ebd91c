"""The port's annealing ladder (varanneal_tpu_torch/anneal/ladder.py through
parallel/ensemble.make_ensemble_ladder) against the JAX ladder and the
SciPy L-BFGS-B oracle ladder, in f64: the action at every mutually
converged rung to 1e-8 relative (the pattern of
tests/test_ladder_integration.py). The fused-kernel action (on the CPU, its
plain version) drives the same ladder to the same actions. The rung values
equal the JAX ladder's exactly, and a bounded ladder with rf caps and
floors matches the JAX one."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu.anneal import run_ladder as run_ladder_jax
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax

from varanneal_tpu_torch.anneal import run_ladder
from varanneal_tpu_torch.anneal.ladder import rung_rf
from varanneal_tpu_torch.api import build_bounds
from varanneal_tpu_torch.kernels.ag import make_action_ag
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, make_action, value_and_grad
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.parallel import make_ensemble_ladder
from tests.oracle import scipy_ladder
from tests.test_ladder_integration import make_twin
from tests.test_torch_bounded import L96_BOX, _l96_problem
from varanneal_tpu_torch.twin import lorenz96_twin

BETAS = np.arange(6)
ALPHA, RF0 = 1.9, 1e-3
KW = dict(maxiter=20000, pgtol=1e-11, ftol=float(np.finfo(float).eps))


@pytest.fixture(scope="module")
def problem():
    D, N_data, Lidx = 5, 21, (0, 1, 3)
    _, Y, t, rng = make_twin(D=D, N_data=N_data, Lidx=Lidx)
    kw = dict(disc="trapezoid", P=np.array([4.0]), pidx=[0])
    sj = build_spec_jax(lorenz96_jax, D, Y, t, Lidx, 1.0 / 0.4 ** 2, **kw)
    st = build_spec(lorenz96, D, Y, t, Lidx, 1.0 / 0.4 ** 2, **kw)
    X0 = np.empty((2, st.n_dof))
    for b in range(2):
        X = np.full((N_data, D), Y.mean()) + 0.5 * rng.normal(
            size=(N_data, D))
        X[:, list(Lidx)] = Y
        X0[b, :-1] = X.ravel()
        X0[b, -1] = 4.0
    act, parts = make_action(st, device="cpu")
    lad = make_ensemble_ladder(act, parts, BETAS, RF0, ALPHA,
                               opts=LBFGSOptions(**KW), store_paths=True,
                               device="cpu")(torch.tensor(X0))
    return sj, st, X0, lad


def _assert_converged_match(A, stat, A_ref, ok_ref):
    both = (stat <= 1) & ok_ref
    assert both.mean() >= 0.8, (stat, ok_ref)
    rel = np.abs(A - A_ref) / np.abs(A_ref)
    # as in tests/test_ladder_integration.py: β=0 is the flattest,
    # data-dominated rung, where two optimizers' stopping points at
    # pgtol=1e-11 differ by up to a few e-8 in action; every constrained
    # rung must meet 1e-8
    assert rel[both][1:].max() <= 1e-8, rel
    assert rel[0] <= 5e-8, rel


def test_ladder_matches_jax(problem):
    """Member 0 starts where tests/test_ladder_integration.py starts. On
    the flat first rungs a stopping point moves the action near the 1e-8
    level under rounding alone (so does the JAX ladder's, restarted from
    X0 * (1 + 1e-15)); member 1 is compared between the port's own two
    paths below."""
    sj, st, X0, lad = problem
    act_j, parts_j = make_action_jax(sj)
    res_j = jax.jit(lambda x0: run_ladder_jax(
        act_j, parts_j, x0, jnp.asarray(BETAS, float), RF0, ALPHA,
        opts=OptsJax(**KW)))(jnp.asarray(X0[0]))
    A, stat = lad.A.numpy(), lad.status.numpy()
    assert A.shape == (2, len(BETAS))
    _assert_converged_match(A[0], stat[0], np.asarray(res_j.A),
                            np.asarray(res_j.status) <= 1)
    np.testing.assert_allclose(A, (lad.ME + lad.FE).numpy(), rtol=1e-12)
    assert lad.paths.shape == (2, len(BETAS), st.n_dof)


def test_ladder_matches_scipy_oracle(problem):
    sj, st, X0, lad = problem
    act, parts = make_action(st, device="cpu")
    vag = value_and_grad(act)

    def vg(z, rf):
        f, g = vag(torch.tensor(z)[None], rf)
        return float(f[0]), g[0].numpy()

    orc = scipy_ladder(vg, X0[0], BETAS, RF0, ALPHA, maxiter=KW["maxiter"],
                       pgtol=KW["pgtol"], factr=1.0)
    _assert_converged_match(lad.A[0].numpy(), lad.status[0].numpy(),
                            orc["A"], orc["exitflags"] == 0)


def test_ag_action_drives_the_same_ladder(problem):
    sj, st, X0, lad = problem
    act, parts = make_action_ag(st, device="cpu", dtype=torch.float64)
    res = run_ladder(act, parts, torch.tensor(X0[1]), BETAS, RF0, ALPHA,
                     opts=LBFGSOptions(**KW), store_paths=False,
                     device="cpu")
    assert res.A.shape == (len(BETAS),) and res.paths is None
    _assert_converged_match(res.A.numpy(), res.status.numpy(),
                            lad.A[1].numpy(), lad.status[1].numpy() <= 1)


@pytest.mark.parametrize("dtype,tdtype", [(jnp.float32, torch.float32),
                                          (jnp.float64, torch.float64)])
def test_rung_rf_matches_xla(dtype, tdtype):
    """rung_rf equals the JAX expression rf0 · α^β exactly (==) at every β
    of the bench's ladder, 0..100, at the bench's rf0 = f32(4e-6·RM)."""
    rf0 = np.float32(4e-6 * lorenz96_twin(D=20, N_data=161, n_obs=8)["RM"])
    ref = np.asarray(jnp.asarray(rf0, dtype) * jnp.asarray(1.5, dtype)
                     ** jnp.arange(101, dtype=dtype), np.float64)
    got = np.array([rung_rf(rf0, 1.5, b, tdtype) for b in range(101)])
    np.testing.assert_array_equal(got, ref)


def test_bounded_ladder_rf_caps_matches_jax():
    """A bounded f64 ladder (β 0..4, rf0 1e-2, α 1.9) with a per-component
    rf cap and floor, through the port's ladder and JAX run_ladder
    (generic projection loop, each with its own action): the action at
    every mutually converged rung to 1e-8 relative, 5e-8 at the flat β = 0
    rung (tests/test_ladder_integration.py's rule); every path
    feasible."""
    spec_j, spec_t, X0 = _l96_problem()
    lo, hi = build_bounds(spec_t, L96_BOX, np.float64)
    N1, D = spec_t.N_f - 1, spec_t.D
    rf_max = np.full((N1, D), np.inf)
    rf_max[:, 2] = 0.03          # caps component 2 from β = 2
    rf_min = np.zeros((N1, D))
    rf_min[:, 4] = 0.05          # floors component 4 up to β = 2
    kw = dict(maxiter=20000, pgtol=1e-10, ftol=float(np.finfo(float).eps))
    betas = np.arange(5)
    act_j, parts_j = make_action_jax(spec_j)
    rj = jax.jit(jax.vmap(lambda z: run_ladder_jax(
        act_j, parts_j, z, betas, 1e-2, 1.9, lower=jnp.asarray(lo),
        upper=jnp.asarray(hi), opts=OptsJax(**kw), rf_max=rf_max,
        rf_min=rf_min)))(jnp.asarray(X0[1:2]))
    act, parts = make_action(spec_t, device="cpu")
    rt = run_ladder(act, parts, torch.tensor(X0[1:2]), betas, 1e-2, 1.9,
                    lower=lo, upper=hi, opts=LBFGSOptions(**kw),
                    rf_max=rf_max, rf_min=rf_min, device="cpu")
    A, A_j = rt.A.numpy(), np.asarray(rj.A)
    both = (rt.status.numpy() <= 1) & (np.asarray(rj.status) <= 1)
    assert both.mean() >= 0.8
    rel = np.abs(A - A_j) / np.abs(A_j)
    tol = np.broadcast_to(np.where(betas == 0, 5e-8, 1e-8), A.shape)
    assert np.all(rel[both] <= tol[both]), rel
    paths = rt.paths.numpy()
    assert np.all(paths >= lo) and np.all(paths <= hi)
