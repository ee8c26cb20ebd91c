"""The compensated (two-float) sums of the port against the JAX package's:
``ops.action.comp_sum`` on adversarial f32 data (to 1e-6·max(1, |sum|),
closer than the plain f32 sum), ``make_action(compensated=True)`` over
every discretization × R shape in f64 (1e-12), K4's plain version
(``kernels.ag.ag_reference(compensated=True)`` with ``combine``) against
``ag_pallas.make_action_ag(compensated=True)`` in Pallas interpret mode
(value 2e-6 relative, gradient as tests/test_ag_pallas.py holds it) and
its accuracy at rf 4e6, the solver on an objective whose values are
float64 while x is float32 (x never promoted), and the facade's
``compensated=True`` with ``engine='ag'`` and ``'auto'`` against the JAX
facade. Torch's default dtype float64 stands for JAX's x64 here, the rule
``ops.action.combine_dtype`` states."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import varanneal_tpu
from varanneal_tpu.kernels import ag_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax
from varanneal_tpu.ops.action import comp_sum as comp_sum_jax
from varanneal_tpu.twin import lorenz96_twin

import varanneal_tpu_torch
from varanneal_tpu_torch.api import build_bounds
from varanneal_tpu_torch.kernels import ag
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, make_action, pack
from varanneal_tpu_torch.ops.action import comp_sum, value_and_grad
from varanneal_tpu_torch.opt import LBFGSOptions, lbfgs_minimize
from tests.test_torch_action import DISCS, R_KINDS, _problem


@pytest.fixture
def f64_default():
    """torch's default dtype float64 (JAX's x64, which conftest enables),
    restored afterwards."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture
def interpret():
    ag_pallas.set_interpret(True)
    yield
    ag_pallas.set_interpret(False)


@pytest.mark.parametrize("N,D", [(8, 128), (24, 128), (168, 256)])
def test_comp_sum_matches_jax(N, D, f64_default):
    """tests/test_ag_pallas.py's adversarial data: large cancellation and
    tiny tail terms."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.0, (N, D)).astype(np.float32)
    x[0, 0] = 3e7
    x[1, 0] = -3e7
    x[2] = 1e-4 * rng.normal(size=D)
    want = np.sum(x.astype(np.float64))
    plain = np.float64(np.sum(x, dtype=np.float32))
    got_j = float(comp_sum_jax(jnp.asarray(x)))
    got = comp_sum(torch.tensor(x))
    assert got.dtype == torch.float64
    tol = 1e-6 * max(1.0, abs(want))
    assert abs(float(got) - got_j) <= tol
    assert abs(float(got) - want) <= tol
    assert abs(float(got) - want) < abs(plain - want) or plain == want
    # one pair per leading index: the rows of a batch sum on their own
    rows = comp_sum(torch.tensor(x), 1)
    np.testing.assert_array_equal(
        rows.numpy(), [float(comp_sum(torch.tensor(r))) for r in x])


@pytest.mark.parametrize("disc", DISCS)
@pytest.mark.parametrize("rm_kind,rf_kind", R_KINDS)
def test_compensated_action_matches_jax(disc, rm_kind, rf_kind):
    seed = DISCS.index(disc) * 10 + R_KINDS.index((rm_kind, rf_kind))
    sj, st, _, XP, RF = _problem(disc, rm_kind, rf_kind, False, seed)
    act_t, parts_t = make_action(st, device="cpu", compensated=True)
    rf_t = torch.tensor(RF) if np.ndim(RF) else RF
    A_t, g_t = value_and_grad(act_t)(torch.tensor(XP), rf_t)
    _, me_t, fe_t = parts_t(torch.tensor(XP), rf_t)
    act_j, parts_j = make_action_jax(sj, compensated=True)
    A_j, g_j = jax.vmap(jax.value_and_grad(act_j), in_axes=(0, None))(
        jnp.asarray(XP), jnp.asarray(RF))
    _, me_j, fe_j = jax.vmap(parts_j, in_axes=(0, None))(jnp.asarray(XP),
                                                        jnp.asarray(RF))
    for a, b in ((A_t, A_j), (me_t, me_j), (fe_t, fe_j)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    scale = np.abs(np.asarray(g_j)).max()
    np.testing.assert_allclose(g_t.numpy() / scale, np.asarray(g_j) / scale,
                               rtol=0, atol=1e-12)


def test_combine_dtype_rule(f64_default):
    """An f32 decision path combines in float64 under torch's default
    float64 (JAX's x64), in float32 under float32; the f64 combine gives
    the JAX compensated value to round-off."""
    sj, st, _, XP, _ = _problem("trapezoid", "scalar", "scalar", False, 7)
    z = XP.astype(np.float32)
    act_t, _ = make_action(st, device="cpu", compensated=True)
    A = act_t(torch.tensor(z), 1e-2)
    act_j, _ = make_action_jax(sj, compensated=True)
    A_j = jax.vmap(act_j, in_axes=(0, None))(jnp.asarray(z),
                                             np.float32(1e-2))
    assert A.dtype == torch.float64 and A_j.dtype == jnp.float64
    np.testing.assert_allclose(A.numpy(), np.asarray(A_j), rtol=1e-6)
    torch.set_default_dtype(torch.float32)
    assert act_t(torch.tensor(z), 1e-2).dtype == torch.float32
    assert make_action(st, device="cpu")[0](torch.tensor(z),
                                            1e-2).dtype == torch.float32


def _k4_problem(N, RM=None):
    tw = lorenz96_twin(D=20, N_data=N, n_obs=8)
    RM = tw["RM"] if RM is None else RM
    kw = dict(disc="trapezoid", P=np.array([4.0]), pidx=[0])
    sj = build_spec_jax(lorenz96_jax, 20, tw["Y"], tw["t"], tw["Lidx"], RM,
                        **kw)
    st = build_spec(lorenz96, 20, tw["Y"], tw["t"], tw["Lidx"], RM, **kw)
    return sj, st, tw


def _draws(spec, tw, rng, B):
    out = []
    for _ in range(B):
        X = rng.normal(2.0, 2.0, (spec.N_f, spec.D))
        rows = np.arange(spec.N_data) * spec.obs_stride
        X[np.ix_(rows, np.asarray(spec.Lidx))] = tw["Y"] + rng.normal(
            0, 0.3, tw["Y"].shape)
        out.append(pack(spec, X, np.array([4.0 + rng.normal()])))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("rm", ["scalar", "per-entry"])
def test_k4_reference_matches_jax_kernel(rm, interpret, f64_default):
    """K4's plain version against the JAX compensated kernel (interpret
    mode): the combined value to 2e-6 relative, the gradient as
    tests/test_ag_pallas.py holds the kernel's (rtol 1e-3, atol 1e-5 of
    max|g|) and equal to K1's plain gradient; the second row of the batch
    gives the value it gives alone."""
    RM = None
    if rm == "per-entry":
        RM = np.random.default_rng(5).uniform(2.0, 8.0, (41, 8))
    sj, st, tw = _k4_problem(41, RM)
    z = _draws(st, tw, np.random.default_rng(3), 2)
    act_jk, _ = ag_pallas.make_action_ag(sj, compensated=True)
    act, _ = ag.make_action_ag(st, device="cpu", dtype=torch.float32,
                               compensated=True)
    c1 = ag.ag_consts(st, "cpu", torch.float32)
    for rf in (1e-3, 1e5):
        rf32 = np.float32(rf)
        A, G = act.value_and_grad(torch.tensor(z), float(rf32))
        assert A.dtype == torch.float64 and G.dtype == torch.float32
        _, G1 = ag.ag_reference(torch.tensor(z), float(rf32), c1)
        torch.testing.assert_close(G, G1, rtol=0, atol=0)
        zb = jnp.asarray(z[0])
        v_j = float(act_jk(zb, rf32))
        g_j = np.asarray(jax.grad(lambda u: act_jk(u, rf32))(zb))
        np.testing.assert_allclose(float(A[0]), v_j, rtol=2e-6)
        np.testing.assert_allclose(G[0].numpy(), g_j, rtol=1e-3,
                                   atol=1e-5 * float(np.max(np.abs(g_j))))
        A1, _ = act.value_and_grad(torch.tensor(z[1]), float(rf32))
        assert float(A1) == float(A[1])


def test_k4_accuracy_beats_plain_f32():
    """At rf 4e6 K4's combined value lies no farther from the f64 action
    of the same (f32) point than K1's plain f32 value, and within 1e-5 of
    it (tests/test_ag_pallas.py's accuracy test)."""
    _, st, tw = _k4_problem(81)
    z = torch.tensor(_draws(st, tw, np.random.default_rng(11), 1))
    rf = float(np.float32(4e6))
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        c4 = ag.ag_consts(st, "cpu", torch.float32, compensated=True)
        A_c, _ = ag.action_and_grad(z, rf, c4, compensated=True)
    finally:
        torch.set_default_dtype(old)
    A_p, _ = ag.ag_reference(z, rf, ag.ag_consts(st, "cpu", torch.float32))
    act64, _ = make_action(st, device="cpu")
    ref = float(act64(z.double(), rf)[0])
    err_plain = abs(float(A_p[0]) - ref)
    err_comp = abs(float(A_c[0]) - ref)
    assert err_comp <= err_plain
    assert err_comp <= 1e-5 * abs(ref)


CASES = ["compact", "two_loop", "compact_pallas", "projection", "subspace"]


@pytest.mark.parametrize("case", CASES)
def test_f32_solve_with_f64_objective(case, f64_default):
    """Under torch's default float64 a compensated f32 objective returns
    float64 values: every loop keeps f in float64, returns x and g in
    float32, and never evaluates the action on a float64 x."""
    D, N = 5, 21
    tw = lorenz96_twin(D=D, N_data=N, n_obs=3)
    st = build_spec(lorenz96, D, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                    disc="trapezoid", P=np.array([8.0]), pidx=[0])
    act, _ = make_action(st, device="cpu", compensated=True)
    vag = value_and_grad(act)
    seen = set()

    def vag32(x):
        seen.add(x.dtype)
        return vag(x, 1e-2)

    rng = np.random.default_rng(2)
    x0 = torch.tensor(rng.normal(1.0, 1.0, (2, st.n_dof)),
                      dtype=torch.float32)
    kw = {}
    direction = "compact"
    if case in ("compact", "two_loop", "compact_pallas"):
        direction = case
    else:
        lo, hi = build_bounds(st, [(-6.0, 6.0)] * D + [(7.0, 9.0)],
                              np.float32)
        kw = dict(lower=lo, upper=hi)
    opts = LBFGSOptions(m=5, maxiter=25, pgtol=1e-4, ftol=1e-6,
                        direction=direction,
                        bounded_algo=("subspace" if case == "subspace"
                                      else "auto"))
    res = lbfgs_minimize(vag32, x0, opts=opts, device="cpu", **kw)
    assert seen == {torch.float32}
    assert res.x.dtype == torch.float32 and res.g.dtype == torch.float32
    assert res.f.dtype == torch.float64
    assert bool(torch.all(res.niter > 0))
    f_end, _ = vag(res.x, 1e-2)
    assert bool(torch.all(f_end < vag(x0, 1e-2)[0]))


@pytest.mark.parametrize("engine", ["ag", "auto"])
def test_facade_compensated_matches_jax(engine, interpret, f64_default):
    """tests/test_ag_pallas.py's facade setup (D=20, N=21, β 0..4,
    maxiter 20, float32): the port's ladder (K4's plain version for
    'ag', the compensated autograd action for 'auto') against the JAX
    facade with the same engine, and 'ag' against 'auto', A to 1e-4
    relative, as that test holds the JAX facade's two engines."""
    tw = lorenz96_twin(D=20, N_data=21, n_obs=8)
    X0 = np.random.default_rng(4).normal(2.0, 2.0, (21, 20))

    def run(mod, f, eng, **ctor):
        ann = mod.Annealer(**ctor)
        ann.set_model(f, 20)
        ann.set_data(tw["Y"].astype(np.float32), t=tw["t"])
        ann.anneal(X0, np.array([4.0]), 1.7, np.arange(5), tw["RM"], 1e-4,
                   tw["Lidx"], [0], opt_args=dict(maxiter=20),
                   compensated=True, dtype=np.float32, engine=eng)
        return ann

    a_j = run(varanneal_tpu, lorenz96_jax, engine)
    a_t = run(varanneal_tpu_torch, lorenz96, engine, device="cpu")
    assert a_t.A_array.dtype == np.float64
    assert a_t.minpaths.dtype == np.float32
    assert np.all(np.isfinite(a_t.A_array))
    np.testing.assert_allclose(a_t.A_array, a_j.A_array, rtol=1e-4)
    if engine == "ag":
        a_x = run(varanneal_tpu_torch, lorenz96, "auto", device="cpu")
        np.testing.assert_allclose(a_t.A_array, a_x.A_array, rtol=1e-4)


def test_facade_compensated_engines_refused():
    """engine='pallas' refuses compensated=True with the reference's
    message; engine='ag' outside K4's envelope refuses too (repeated
    observed columns: ROADMAP.md §3, fault 6)."""
    tw = lorenz96_twin(D=20, N_data=21, n_obs=8)
    X0 = np.zeros((21, 20))
    ann = varanneal_tpu_torch.Annealer(device="cpu")
    ann.set_model(lorenz96, 20)
    ann.set_data(tw["Y"], t=tw["t"])
    kw = dict(P0=np.array([4.0]), alpha=1.7, beta_array=np.arange(2),
              RM=tw["RM"], RF0=1e-4, Lidx=tw["Lidx"], Pidx=[0],
              opt_args=dict(maxiter=5), compensated=True)
    with pytest.raises(ValueError, match="not the blocked FE kernel"):
        ann.anneal(X0, engine="pallas", **kw)
    rep = list(tw["Lidx"][:-1]) + [tw["Lidx"][0]]
    with pytest.raises(ValueError, match="engine='ag' unsupported"):
        ann.anneal(X0, engine="ag", disc="euler",
                   **dict(kw, Lidx=rep))
