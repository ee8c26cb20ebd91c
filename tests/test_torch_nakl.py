"""BASELINE config #3's model in the port (varanneal_tpu_torch/models/
nakl.py, twin.nakl_twin) and K6 on it (kernels/fe.py), on the CPU, held
against the JAX package with inputs made from numpy seeds:

- ``nakl`` in f64 against the JAX ``nakl`` and tests/oracle.py's
  ``nakl_np`` (1e-12), with and without a stimulus, constant and
  per-row parameters;
- the NumPy helpers (``nakl_param_boxes``, ``nakl_log_model``,
  ``nakl_ss_gates``, ``nakl_ensemble_inits``: the same draws from the
  same rng) and ``nakl_twin``, equal to the JAX package's;
- K6's plain NaKL versions through the port's autograd Function against
  ``fe_pallas.make_fe_pallas`` in interpret mode (as tests/test_pallas.py
  runs it): the four discs × scalar and (N_f-1, 4) rf with pidx [1..5],
  and all 18 parameters on two of them, value and gradient to 1e-11;
  the batched Hermite–Simpson path (B=3) against JAX's vmap;
- the log-space model of ``nakl_log_model(NAKL_TAU_IDX + NAKL_G_IDX)``,
  which the JAX package's Pallas kernels cannot trace (its model closes
  over the index array, and pallas_call refuses a kernel that captures a
  constant): against the JAX package's XLA model error and jax.grad over
  the four discs;
- the envelope: NaKL accepted, each refusal naming its condition.

N_f = 33 is avoided: jaxlib's CPU backend corrupts the f64 gradient of
this model at exactly that size (tests/test_pallas.py)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu import models as models_jax
from varanneal_tpu import twin as twin_jax
from varanneal_tpu.kernels import fe_pallas
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops.action import (merge_params as merge_params_jax,
                                      model_error as model_error_jax)

from varanneal_tpu_torch import models, twin
from varanneal_tpu_torch.kernels import fe
from varanneal_tpu_torch.ops import build_spec
from varanneal_tpu_torch.ops.spec import spec_from_reference
from tests.oracle import nakl_np

CPU = torch.device("cpu")
LOG_IDX = models.NAKL_TAU_IDX + models.NAKL_G_IDX


@pytest.fixture(autouse=True)
def _interpret_mode():
    fe_pallas.set_interpret(True)
    yield
    fe_pallas.set_interpret(False)


def _states(rng, shape):
    """Physiological NaKL states: V in (-80, 40), gates in (0, 1)."""
    V = rng.uniform(-80.0, 40.0, shape + (1,))
    g = rng.uniform(0.02, 0.98, shape + (3,))
    return np.concatenate([V, g], axis=-1)


def _params(rng, shape=()):
    p = np.asarray(models.NAKL_P_TRUE)
    return p * (1.0 + 0.1 * rng.uniform(-1, 1, shape + (19,)))


def test_nakl_matches_jax_and_oracle():
    """f64: (B, R, 4) states, constant and per-row (R, 19) parameters,
    with and without a stimulus."""
    rng = np.random.default_rng(0)
    x = _states(rng, (3, 17))
    stim = rng.uniform(-25, 60, (17, 1))
    for p in (_params(rng), _params(rng, (17,))):
        for arg_np, arg_t, arg_j in (
                ((p, stim), (torch.tensor(p), torch.tensor(stim)),
                 (jnp.asarray(p), jnp.asarray(stim))),
                (p, torch.tensor(p), jnp.asarray(p))):
            got = models.nakl(None, torch.tensor(x), arg_t).numpy()
            want = np.asarray(models_jax.nakl(None, jnp.asarray(x), arg_j))
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(got, nakl_np(None, x, arg_np),
                                       rtol=1e-12, atol=1e-12)


def test_nakl_helpers_match_jax():
    """The constants, nakl_param_boxes (wide, log, shrunk), nakl_log_model
    (P_base; nakl itself for no log coordinate; the model's values),
    nakl_ss_gates and nakl_ensemble_inits (the same draws from the same
    rng, in every mode) equal the JAX package's."""
    for nm in ("NAKL_PNAMES", "NAKL_P_TRUE", "NAKL_PBOUNDS",
               "NAKL_STATE_BOUNDS", "NAKL_TAU_IDX", "NAKL_G_IDX"):
        assert getattr(models, nm) == getattr(models_jax, nm)
    pidx = list(range(1, 19))
    for kw in (dict(), dict(log_tau=True), dict(log_g=True, log_tau=True),
               dict(box_shrink=4.0, seed=3),
               dict(box_shrink=3.0, box_shrink_all=True, log_tau=True)):
        bt, lt = models.nakl_param_boxes(pidx, **kw)
        bj, lj = models_jax.nakl_param_boxes(pidx, **kw)
        assert lt == lj
        np.testing.assert_array_equal(np.asarray(bt), np.asarray(bj))
    f0, P0 = models.nakl_log_model(())
    assert f0 is models.nakl
    np.testing.assert_array_equal(P0, models_jax.nakl_log_model(())[1])
    ft, Pt = models.nakl_log_model(LOG_IDX)
    fj, Pj = models_jax.nakl_log_model(LOG_IDX)
    np.testing.assert_array_equal(Pt, Pj)
    assert ft.log_idx == LOG_IDX and ft.base is models.nakl
    rng = np.random.default_rng(1)
    x = _states(rng, (5,))
    stim = rng.uniform(0, 30, (5, 1))
    np.testing.assert_allclose(
        ft(None, torch.tensor(x), (torch.tensor(Pt), torch.tensor(stim))),
        np.asarray(fj(None, jnp.asarray(x), (jnp.asarray(Pj),
                                             jnp.asarray(stim)))),
        rtol=1e-12, atol=1e-12)
    V = rng.uniform(-80, 30, 41)
    for a, b in zip(models.nakl_ss_gates(V), models_jax.nakl_ss_gates(V)):
        np.testing.assert_array_equal(a, b)
    pb, _ = models.nakl_param_boxes([1, 2, 3, 4, 5])
    pool = np.asarray([[110.0, 45.0, 22.0, -70.0, 0.4]])
    for kw in (dict(), dict(gates_own_ss=True), dict(gates_random=True),
               dict(seed_pool=pool, seed_jitter=0.05)):
        got = models.nakl_ensemble_inits(
            np.random.default_rng(3), 4, pb, [V, V + 1.0],
            pidx=[1, 2, 3, 4, 5], **kw)
        want = models_jax.nakl_ensemble_inits(
            np.random.default_rng(3), 4, pb, [V, V + 1.0],
            pidx=[1, 2, 3, 4, 5], **kw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_nakl_twin_matches_jax():
    for kw in (dict(N=81, seed=7), dict(N=60, seed=11, seg=20,
                                        i_min=-25.0, i_max=60.0)):
        a, b = twin.nakl_twin(**kw), twin_jax.nakl_twin(**kw)
        assert set(a) == set(b)
        for k in ("traj", "V", "stim", "t"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["sigma"] == b["sigma"]


def _specs(disc, pidx=(1, 2, 3, 4, 5), log=False, N=18):
    """tests/test_pallas.py's NaKL problem (nakl_twin seg 8), cut to N=18
    (N_f = 18, or 35 under Hermite–Simpson: 3 blocks of 8 rows, the last
    short), in both packages; the log model with every parameter
    estimated in log space where ``log``."""
    tw = twin_jax.nakl_twin(N=N, dt=0.04, sigma=1.0, seed=7, seg=8)
    if log:
        fj, P = models_jax.nakl_log_model(LOG_IDX)
        ft = models.nakl_log_model(LOG_IDX)[0]
    else:
        fj, ft = models_jax.nakl, models.nakl
        P = np.asarray(models.NAKL_P_TRUE)
    sj = build_spec_jax(fj, 4, tw["V"], tw["t"], [0], 1.0, disc=disc, P=P,
                        pidx=list(pidx), stim=tw["stim"])
    return sj, spec_from_reference(dataclasses.asdict(sj), ft), tw


def _draw(st, tw, seed, B=None):
    """States near the data (V from the data, gates from their steady
    states, jittered) and parameters 5 % off their base values."""
    rng = np.random.default_rng(seed)
    n = st.N_f
    V = np.interp(np.arange(n) * (tw["V"].shape[0] - 1) / (n - 1),
                  np.arange(tw["V"].shape[0]), tw["V"][:, 0])
    shape = () if B is None else (B,)
    gates = np.stack(models.nakl_ss_gates(V), axis=-1)
    X = np.concatenate([np.broadcast_to(V[:, None], shape + (n, 1)),
                        np.clip(gates + 0.05 * rng.normal(
                            size=shape + (n, 3)), 0.01, 0.99)], axis=-1)
    X = X + 0.2 * rng.normal(size=X.shape) * np.array([1, 0, 0, 0])
    pb = np.asarray(st.P_base)[list(st.pidx)]
    pest = pb + 0.05 * np.abs(pb) * rng.normal(size=shape + (len(st.pidx),))
    return X, pest


def _rf(kind, st, rng):
    if kind == "scalar":
        return 2e-3
    return rng.uniform(0.5, 2.0, size=(st.N_f - 1, st.D))


def _port_fe(st, X, pest, rf):
    f = fe.make_fe_pallas(st, block_n=8, device=CPU)
    Xt = torch.tensor(X, requires_grad=True)
    pt = torch.tensor(pest, requires_grad=True)
    v = f(Xt, pt, rf if np.ndim(rf) == 0 else torch.tensor(rf))
    gX, gp = torch.autograd.grad(v.sum(), (Xt, pt))
    return v.detach().numpy(), gX.numpy(), gp.numpy()


def _jax_value_and_grad(fn, X, pest, has_aux=False):
    """fn's value (its aux with ``has_aux``) and its gradient over (X,
    pest), by one jitted jax.value_and_grad, as NumPy arrays."""
    v, g = jax.jit(jax.value_and_grad(fn, argnums=(0, 1), has_aux=has_aux))(
        jnp.asarray(X), jnp.asarray(pest))
    if has_aux:
        return (v[0], np.asarray(v[1])), tuple(np.asarray(a) for a in g)
    return float(v), tuple(np.asarray(a) for a in g)


def _check(v, gX, gp, v_j, gX_j, gp_j):
    np.testing.assert_allclose(v, v_j, rtol=1e-11)
    scale = np.max(np.abs(gX_j))
    np.testing.assert_allclose(gX, gX_j, rtol=1e-11, atol=1e-11 * scale)
    np.testing.assert_allclose(gp, gp_j, rtol=1e-11,
                               atol=1e-11 * np.max(np.abs(gp_j)))


@pytest.mark.parametrize("disc,rf_kind,pidx", [
    ("euler", "scalar", (1, 2, 3, 4, 5)), ("euler", "diag", (1, 2, 3, 4, 5)),
    ("trapezoid", "scalar", (1, 2, 3, 4, 5)),
    ("trapezoid", "diag", tuple(range(1, 19))),
    ("forwardmap", "scalar", (1, 2, 3, 4, 5)),
    ("forwardmap", "diag", (1, 2, 3, 4, 5)),
    ("SimpsonHermite", "scalar", tuple(range(1, 19))),
    ("SimpsonHermite", "diag", (1, 2, 3, 4, 5))])
def test_fe_nakl_matches_jax(disc, rf_kind, pidx):
    """The plain versions (torch nakl, torch.func.vjp) through the port's
    autograd Function against the JAX package's make_fe_pallas in
    interpret mode, block_n=8 (several blocks, a short last one), with
    the stimulus: value 1e-11 relative, gradient 1e-11 (of max|g| where
    an entry is near zero)."""
    sj, st, tw = _specs(disc, pidx)
    assert fe_pallas.fe_supported(sj, 1.0) and fe.fe_supported(st, 1.0)
    assert fe.fe_kernel_supported(st, 1.0, torch.float64)
    X, pest = _draw(st, tw, 3)
    rf = _rf(rf_kind, st, np.random.default_rng(4))
    fj = fe_pallas.make_fe_pallas(sj, block_n=8)
    rf_j = jnp.asarray(rf)
    v_j, g_j = _jax_value_and_grad(lambda x, p: fj(x, p, rf_j), X, pest)
    _check(*_port_fe(st, X, pest, rf), v_j, *g_j)


def test_fe_nakl_log_model_matches_jax():
    """The log model (18 parameters, the timescales and conductances in
    log space): the wrapper exponentiates before the plain version and
    multiplies their gradient by p after it; against the JAX package's
    XLA model error and jax.grad (its Pallas K6 cannot trace this model),
    the four discs × both rf kinds."""
    for disc in ("euler", "trapezoid", "forwardmap", "SimpsonHermite"):
        sj, st, tw = _specs(disc, tuple(range(1, 19)), log=True)
        assert fe.model_of(st.f) == ("nakl", LOG_IDX)
        X, pest = _draw(st, tw, 5)
        for kind in ("scalar", "diag"):
            rf = _rf(kind, st, np.random.default_rng(6))
            rf_j = jnp.asarray(rf)

            def me(x, p):
                return model_error_jax(sj, x, merge_params_jax(
                    sj, p, x.dtype), rf_j)

            v_j, g_j = _jax_value_and_grad(me, X, pest)
            _check(*_port_fe(st, X, pest, rf), v_j, *g_j)


def test_fe_nakl_batched_sh_matches_jax_vmap():
    """B=3 Hermite–Simpson members with an (N_f-1, 4) rf shared by the
    batch: the port's batch against JAX's vmap of the same fe (the
    batched-grid kernels K6d), values and the summed FE's gradient."""
    sj, st, tw = _specs("SimpsonHermite")
    X, pest = _draw(st, tw, 7, B=3)
    rf = _rf("diag", st, np.random.default_rng(8))
    fj = fe_pallas.make_fe_pallas(sj, block_n=8)
    rf_j = jnp.asarray(rf)
    vj = jax.vmap(lambda x, p: fj(x, p, rf_j))
    (_, v_j), g_j = _jax_value_and_grad(
        lambda x, p: (jnp.sum(vj(x, p)), vj(x, p)), X, pest, has_aux=True)
    v, gX, gp = _port_fe(st, X, pest, rf)
    assert v.shape == (3,)
    _check(v, gX, gp, v_j, *g_j)


def test_fe_nakl_envelope_and_blocks():
    """NaKL is accepted with and without a stimulus, plain and log, f32
    and f64; each refusal names its condition; the plain partials sum to
    FE·norm, and the kernels' wrappers take CUDA tensors only."""
    _, st, tw = _specs("SimpsonHermite")
    for dt in (torch.float32, torch.float64):
        assert fe.fe_refusal(st, 1.0, dt) is None
    assert fe.fe_kernel_supported(dataclasses.replace(st, stim_f=None))
    assert fe.fe_kernel_supported(_specs("trapezoid", log=True)[1])
    st_e = dataclasses.replace(st, N_f=st.N_f - 1, stim_f=st.stim_f[:-1])
    for bad, why in (
            (dataclasses.replace(st, D=5), "D = 5"),
            (dataclasses.replace(st, P_base=np.ones(18), pidx=(1,)),
             "NP = 18"),
            (dataclasses.replace(st, pidx=(1, 1)), "pidx"),
            (dataclasses.replace(st, stim_f=np.ones((3, 1))), "stimulus"),
            (dataclasses.replace(st, P_base=np.ones((st.N_f, 19))),
             "time-dependent"),
            (st_e, "even N_f"),
            (dataclasses.replace(st, f=lambda t, x, p: x), "neither")):
        assert why in fe.fe_refusal(bad, 1.0, torch.float64)
        assert not fe.fe_kernel_supported(bad, 1.0, torch.float64)
    assert "rf of shape" in fe.fe_refusal(st, np.ones((3, 4)))
    assert "dtype" in fe.fe_refusal(st, 1.0, torch.float16)
    with pytest.raises(NotImplementedError, match="neither"):
        fe.select_action(dataclasses.replace(st, f=lambda t, x, p: x),
                         1e-2, engine="pallas", device="cpu")
    act, _ = fe.select_action(st, 1e-2, engine="pallas", device="cpu")
    assert act.engine == "pallas"
    c = fe.fe_consts(st, torch.float64, CPU, block_n=8)
    assert (c.model, c.NP, c.M, c.n_blocks(2)) == ("nakl", 19, 17,
                                                         3)
    X, pest = _draw(st, tw, 9, B=2)
    Xt, pt = torch.tensor(X), torch.tensor(pest)
    parts = fe.sh_fwd_reference(Xt, pt, 1e-2, c)
    assert parts.shape == (2, 3)
    sp = fe._action.device_spec(st, CPU, torch.float64)
    me = fe._action.model_error(sp, Xt, fe._action.merge_params(sp, pt),
                                1e-2)
    np.testing.assert_allclose((parts.sum(1) / c.norm).numpy(), me.numpy(),
                               rtol=1e-13)
    g_rows, gp = fe.fe_adjoint(Xt, pt, 1e-2, c)
    assert g_rows.shape == (2, st.N_f, 4) and gp.shape == (2, 19)
    for kern in (fe.sh_fwd_kernel, fe.sh_vag_kernel):
        with pytest.raises(ValueError):
            kern(Xt, pt, 1e-2, c)
