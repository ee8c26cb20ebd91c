"""K5 of the port (varanneal_tpu_torch/kernels/ag.py: make_action_ag_t,
ag_reference, agt_supported; the kernel is csrc/agt_kernel.cu, whose
plain version runs here on the CPU) against the JAX package.

- f64: the plain version against JAX's XLA action (ops.action.make_action)
  value and gradient, 1e-12 relative (value) and 1e-12 of max|g|, over
  the trapezoid rule, Euler and a forward map × scalar and (N_f-1, D) rf;
- f32: against JAX's own K5 (ag_pallas.make_action_ag_t, interpret mode,
  as tests/test_ag_pallas.py runs it) at observation stride 1, to that
  test's 2e-5;
- stride 2 (dt_model = dt/2): against JAX's XLA action (f64, 1e-12) and
  JAX's K1 (make_action_ag, interpret mode, f32, 2e-5), not against JAX's
  K5, which puts the observations at model rows 0..N_data-1 there
  (ROADMAP.md §3);
- the reference's K1 with a repeated observed column, which leaves the
  XLA action's function (ROADMAP.md §3, fault 6; the port refuses it);
- the envelope (Hermite–Simpson and D = 65 refused), ``agt_refusal``
  naming each condition, a problem past the old shared-memory bound
  (N_f = 1,001 at D = 64: (N_f-1)·D f32 residuals no block could hold)
  inside it and against JAX's XLA action, and the port's ladder run
  through make_action_ag_t.

Both packages get the identical problem through
``ops.spec.spec_from_reference``; inputs come from numpy seeds."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu.kernels import ag_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax

from varanneal_tpu_torch.anneal import run_ladder
from varanneal_tpu_torch.kernels import ag
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.models.lorenz import lorenz63
from varanneal_tpu_torch.ops import build_spec, make_action, pack
from varanneal_tpu_torch.ops.spec import spec_from_reference
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.twin import lorenz96_twin

CPU = torch.device("cpu")
DISCS = ("trapezoid", "euler", "forwardmap")


@pytest.fixture(autouse=True)
def _interpret_mode():
    ag_pallas.set_interpret(True)
    yield
    ag_pallas.set_interpret(False)


def _specs(disc, stride=1, N_data=41, D=20):
    """The twin's problem in both packages (F estimated)."""
    tw = lorenz96_twin(D=D, N_data=N_data, n_obs=8)
    kw = {} if stride == 1 else dict(
        dt_model=float(tw["t"][1] - tw["t"][0]) / stride)
    sj = build_spec_jax(lorenz96_jax, D, tw["Y"], tw["t"], tw["Lidx"],
                        tw["RM"], disc=disc, P=np.array([4.0]), pidx=[0],
                        **kw)
    st = spec_from_reference(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)},
        lorenz96)
    return tw, sj, st


def _draws(st, tw, B=2, seed=0):
    """Data-informed points (tests/test_ag_pallas.py's ``_z0``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        X = rng.normal(2.0, 2.0, (st.N_f, st.D))
        rows = np.arange(st.N_data) * st.obs_stride
        X[np.ix_(rows, np.asarray(st.Lidx))] = tw["Y"] + rng.normal(
            0, 0.3, tw["Y"].shape)
        out.append(pack(st, X, np.array([4.0 + rng.normal()])))
    return np.stack(out)


def _rf(st, kind, seed=1):
    if kind == "scalar":
        return 3.0
    return np.random.default_rng(seed).uniform(0.5, 2.0, (st.N_f - 1, st.D))


def _jax_vag(action, Z, rf):
    rf = jnp.asarray(rf, Z.dtype)
    return jax.vmap(jax.value_and_grad(lambda u: action(u, rf)))(Z)


def _port_vag(st, Z, rf, dtype):
    act, _ = ag.make_action_ag_t(st, device=CPU, dtype=dtype)
    rf_t = rf if np.ndim(rf) == 0 else torch.tensor(rf, dtype=dtype)
    return act.value_and_grad(torch.tensor(Z, dtype=dtype), rf_t)


def _assert_close(A, G, Aj, Gj, tol):
    Aj, Gj = np.asarray(Aj, np.float64), np.asarray(Gj, np.float64)
    np.testing.assert_allclose(A.double().numpy(), Aj, rtol=tol, atol=0)
    scale = np.abs(Gj).max()
    np.testing.assert_allclose(G.double().numpy() / scale, Gj / scale,
                               rtol=0, atol=tol)


@pytest.mark.parametrize("rf_kind", ["scalar", "diag"])
@pytest.mark.parametrize("disc", DISCS)
def test_plain_matches_xla_f64(disc, rf_kind):
    tw, sj, st = _specs(disc)
    Z = _draws(st, tw)
    rf = _rf(st, rf_kind)
    Aj, Gj = _jax_vag(make_action_jax(sj)[0], jnp.asarray(Z), rf)
    A, G = _port_vag(st, Z, rf, torch.float64)
    _assert_close(A, G, Aj, Gj, 1e-12)


@pytest.mark.parametrize("disc", DISCS)
def test_plain_matches_jax_k5_f32(disc):
    """f32 against JAX's K5 at stride 1, scalar rf (tests/test_ag_pallas.py's
    test_transposed_matches_xla shape and bound)."""
    tw, sj, st = _specs(disc)
    assert ag_pallas.agt_supported(sj, jnp.float32(3.0))
    Z = _draws(st, tw).astype(np.float32)
    Aj, Gj = _jax_vag(ag_pallas.make_action_ag_t(sj)[0], jnp.asarray(Z),
                      np.float32(3.0))
    A, G = _port_vag(st, Z, 3.0, torch.float32)
    _assert_close(A, G, Aj, Gj, 2e-5)


def test_stride2_matches_xla_and_k1():
    """Observations every second model row: the port's K5 is the XLA
    action's function (f64, 1e-12) and K1's (JAX's make_action_ag in
    interpret mode, f32, 2e-5), for a scalar and an (N_f-1, D) rf."""
    tw, sj, st = _specs("trapezoid", stride=2)
    assert st.obs_stride == 2 and ag.agt_supported(st, 3.0)
    Z = _draws(st, tw)
    for kind in ("scalar", "diag"):
        rf = _rf(st, kind)
        Aj, Gj = _jax_vag(make_action_jax(sj)[0], jnp.asarray(Z), rf)
        A, G = _port_vag(st, Z, rf, torch.float64)
        _assert_close(A, G, Aj, Gj, 1e-12)
    Z32 = Z.astype(np.float32)
    Aj, Gj = _jax_vag(ag_pallas.make_action_ag(sj)[0], jnp.asarray(Z32),
                      np.float32(3.0))
    A, G = _port_vag(st, Z32, 3.0, torch.float32)
    _assert_close(A, G, Aj, Gj, 2e-5)


def test_envelope():
    tw, sj, st = _specs("trapezoid")
    for disc in DISCS:
        sp = dataclasses.replace(st, disc=disc)
        assert ag.agt_supported(sp, 1.0)
        assert ag.agt_supported(sp, np.ones((st.N_f - 1, st.D)),
                                torch.float64)
    assert not ag.agt_supported(st, np.ones((2, st.N_f - 1, st.D)))
    assert not ag.agt_supported(st, 1.0, torch.float16)
    sh = dataclasses.replace(st, disc="SimpsonHermite")
    assert not ag.agt_supported(sh, 1.0)
    with pytest.raises(ValueError):
        ag.make_action_ag_t(sh, device=CPU)
    for D, ok in ((64, True), (65, False)):
        twd = lorenz96_twin(D=D, N_data=21, n_obs=8)
        sd = build_spec(lorenz96, D, twd["Y"], twd["t"], twd["Lidx"],
                        twd["RM"], disc="trapezoid", P=np.array([4.0]),
                        pidx=[0])
        assert ag.agt_supported(sd, 1.0) is ok
    s63 = dataclasses.replace(st, f=lorenz63)
    assert not ag.agt_supported(s63, 1.0)
    act, _ = ag.make_action_ag_t(st, device=CPU)
    with pytest.raises(ValueError):            # a per-member rf
        act.value_and_grad(torch.zeros(2, st.n_dof),
                           torch.ones(2, st.N_f - 1, st.D))
    if not torch.cuda.is_available():         # device=None means the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ag.make_action_ag_t(st)


def test_agt_refusal_names_each_condition():
    """agt_refusal names the first condition a problem fails, and
    make_action_ag_t raises with that text; inside the envelope it is
    None."""
    tw, sj, st = _specs("trapezoid")
    assert ag.agt_refusal(st, 1.0) is None
    twn = lorenz96_twin(D=20, N_data=41, n_obs=8)
    rep = build_spec(lorenz96, 20, twn["Y"][:, [0, 0, 1, 2, 3, 4, 5, 6]],
                     twn["t"], [0, 0, 1, 2, 3, 4, 5, 6], twn["RM"],
                     disc="trapezoid", P=np.array([4.0]), pidx=[0])
    big = dataclasses.replace(st, N_f=2**31 // st.D + 1)
    for bad, rf, dtype, why in (
            (dataclasses.replace(st, disc="SimpsonHermite"), 1.0,
             torch.float32, "disc 'SimpsonHermite'"),
            (dataclasses.replace(st, f=lorenz63), 1.0, torch.float32,
             "model"),
            (dataclasses.replace(st, D=65), 1.0, torch.float32, "D = 65"),
            (dataclasses.replace(st, D=3), 1.0, torch.float32, "D = 3"),
            (dataclasses.replace(st, P_base=np.array([4.0, 1.0])), 1.0,
             torch.float32, "parameters"),
            (st, np.ones((2, st.N_f - 1, st.D)), torch.float32,
             "rf of shape"),
            (dataclasses.replace(st, RM=np.ones((2, 3, 4, 5))), 1.0,
             torch.float32, "RM rank 4"),
            (st, 1.0, torch.float16, "dtype"),
            (dataclasses.replace(st, t_f=np.asarray(st.t_f) ** 2), 1.0,
             torch.float32, "non-uniform"),
            (rep, 1.0, torch.float32, "repeated observed columns"),
            (big, 1.0, torch.float32, "32-bit index range")):
        got = ag.agt_refusal(bad, rf, dtype)
        assert got is not None and why in got, (why, got)
        assert not ag.agt_supported(bad, rf, dtype)
    with pytest.raises(ValueError, match="D = 65"):
        ag.make_action_ag_t(dataclasses.replace(st, D=65), device=CPU)


def test_past_old_smem_bound_matches_xla():
    """N_f = 1,001 at D = 64: the (N_f-1)·D f32 weighted residuals (256
    KB) that the first port kept in one block's shared memory do not fit
    there (227 KB), and the walk needs none of it, so K5's envelope takes
    the problem, as the reference's agt_supported does. Its plain version
    against JAX's XLA action and jax.grad in f64 to 1e-12, over the three
    rules × scalar and (N_f-1, D) rf."""
    tw = lorenz96_twin(D=64, N_data=1001, n_obs=16)
    for disc in DISCS:
        sj = build_spec_jax(lorenz96_jax, 64, tw["Y"], tw["t"], tw["Lidx"],
                            tw["RM"], disc=disc, P=np.array([4.0]),
                            pidx=[0])
        st = spec_from_reference(
            {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)},
            lorenz96)
        assert (st.N_f - 1) * st.D * 4 > ag.SMEM_LIMIT
        assert ag_pallas.agt_supported(sj, jnp.float32(3.0))
        assert ag.agt_supported(st, 3.0, torch.float32)
        Z = _draws(st, tw, B=1)
        for kind in ("scalar", "diag"):
            rf = _rf(st, kind)
            assert ag.agt_supported(st, rf, torch.float64)
            Aj, Gj = _jax_vag(make_action_jax(sj)[0], jnp.asarray(Z), rf)
            A, G = _port_vag(st, Z, rf, torch.float64)
            _assert_close(A, G, Aj, Gj, 1e-12)


@pytest.mark.parametrize("rf_kind", ["scalar", "diag"])
def test_ladder_through_k5(rf_kind):
    """run_ladder over make_action_ag_t against the autograd action, f64,
    one member, 2 rungs from near the truth (rf0 = RM, scaled per
    component for the (N_f-1, D) rf), every rung solved to pgtol: the same
    records to 1e-8 relative, and the autograd backward of the K5 action
    equal to its value_and_grad."""
    tw, sj, st = _specs("euler")
    rng = np.random.default_rng(3)
    X0 = torch.tensor(pack(
        st, tw["traj"] + 0.3 * rng.normal(size=tw["traj"].shape),
        np.array([tw["F"] + 0.5 * rng.normal()]))[None])
    rf0 = float(tw["RM"]) * (1.0 if rf_kind == "scalar" else _rf(st, "diag"))
    opts = LBFGSOptions(maxiter=500, m=5, pgtol=1e-8, ftol=0.0)
    kw = dict(opts=opts, store_paths=False, device=CPU)
    act, parts = ag.make_action_ag_t(st, device=CPU, dtype=torch.float64)
    act_x, _ = make_action(st, device=CPU)
    r_k = run_ladder(act, parts, X0, np.arange(2), rf0, 1.5, **kw)
    r_x = run_ladder(act_x, parts, X0, np.arange(2), rf0, 1.5, **kw)
    assert int(r_k.niter.sum()) > 0
    assert bool((r_k.status == 0).all()) and bool((r_x.status == 0).all())
    torch.testing.assert_close(r_k.A, r_x.A, rtol=1e-8, atol=0)
    x = X0.clone().requires_grad_(True)
    rf_b = rf0 if np.ndim(rf0) == 0 else torch.tensor(rf0)
    act(x, rf_b).sum().backward()
    torch.testing.assert_close(x.grad, act.value_and_grad(X0, rf_b)[1],
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["obs_stride 2", "SimpsonHermite"])
def test_reference_k5_faults_not_carried_over(case):
    """The reference's K5 (ag_pallas.make_action_ag_t, interpret mode)
    leaves the XLA action's function in two places that its predicate
    admits (ROADMAP.md §3): at observation stride 2 it reads the data at
    model rows 0..N_data-1, and under Hermite–Simpson it computes the
    forward-map residual. The port's K5 gives the XLA action's value at
    stride 2 and refuses Hermite–Simpson. One normal draw from
    default_rng(0), F estimated, rf = 1, f32; run with -s for the
    numbers."""
    disc = "SimpsonHermite" if case == "SimpsonHermite" else "trapezoid"
    tw, sj, st = _specs(disc, stride=2 if disc == "trapezoid" else 1,
                        N_data=21 if disc == "SimpsonHermite" else 41)
    z = np.random.default_rng(0).normal(size=(1, sj.n_dof)).astype(
        np.float32)
    assert ag_pallas.agt_supported(sj, jnp.float32(1.0))
    A_t, G_t = _jax_vag(ag_pallas.make_action_ag_t(sj)[0], jnp.asarray(z),
                        np.float32(1.0))
    A_x, G_x = _jax_vag(make_action_jax(sj)[0], jnp.asarray(z),
                        np.float32(1.0))
    g_err = float(np.max(np.abs(np.asarray(G_t) - np.asarray(G_x)))
                  / np.max(np.abs(np.asarray(G_x))))
    print(f"{case}: the reference's K5 A = {float(A_t[0]):.6f}, the XLA "
          f"action's {float(A_x[0]):.6f}; its gradient off by "
          f"{g_err:.3f} of max|g|")
    assert abs(float(A_t[0]) - float(A_x[0])) > 1e-2 * abs(float(A_x[0]))
    if disc == "SimpsonHermite":
        assert not ag.agt_supported(st, 1.0)
        return
    A, G = _port_vag(st, z, 1.0, torch.float32)
    _assert_close(A, G, A_x, G_x, 2e-5)


def test_reference_k1_repeated_columns_fault():
    """The reference's K1 (ag_pallas.make_action_ag, interpret mode)
    leaves the XLA action's function where its predicate admits repeated
    observed columns (ROADMAP.md §3, fault 6): the trapezoid rule with
    Lidx the twin's 8 columns and its first column again (Y's first
    column repeated to match), D = 20, N_data = 21, F estimated, one
    normal draw from default_rng(0), rf = 1, f32. Its host-side
    embedding writes each observed column once, so the repeated one
    counts once in its ME where the XLA action counts it twice. The
    port's K1 refuses repeated columns, naming the fault. Run with -s
    for the numbers."""
    tw = lorenz96_twin(D=20, N_data=21, n_obs=8)
    Lidx = list(tw["Lidx"]) + [int(tw["Lidx"][0])]
    Y = np.concatenate([tw["Y"], tw["Y"][:, :1]], axis=1)
    sj = build_spec_jax(lorenz96_jax, 20, Y, tw["t"], Lidx, tw["RM"],
                        disc="trapezoid", P=np.array([4.0]), pidx=[0])
    st = spec_from_reference(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)},
        lorenz96)
    z = np.random.default_rng(0).normal(size=(1, sj.n_dof)).astype(
        np.float32)
    assert ag_pallas.ag_supported(sj, jnp.float32(1.0))
    A_k, G_k = _jax_vag(ag_pallas.make_action_ag(sj)[0], jnp.asarray(z),
                        np.float32(1.0))
    A_x, G_x = _jax_vag(make_action_jax(sj)[0], jnp.asarray(z),
                        np.float32(1.0))
    g_err = float(np.max(np.abs(np.asarray(G_k) - np.asarray(G_x)))
                  / np.max(np.abs(np.asarray(G_x))))
    print(f"repeated observed column: the reference's K1 A = "
          f"{float(A_k[0]):.6f}, the XLA action's {float(A_x[0]):.6f}; its "
          f"gradient off by {g_err:.3f} of max|g|")
    assert abs(float(A_k[0]) - float(A_x[0])) > 1e-2 * abs(float(A_x[0]))
    why = ag.ag_refusal(st, 1.0)
    assert why is not None and "repeated observed columns" in why
    assert "fault 6" in why
    # the port's plain action (what the facade runs instead) is the XLA
    # action's function
    A_p = make_action(st, device=CPU)[0](torch.tensor(z), 1.0)
    np.testing.assert_allclose(float(A_p[0]), float(A_x[0]), rtol=2e-5)
