"""K1 and K4 of the port on the built-in row-level models: NaKL (with and
without its stimulus), Colpitts and Lorenz-63 (varanneal_tpu_torch/
kernels/ag.py; the kernels are csrc/ag_models_kernel.cu and, inside K2/K3,
the same walk, whose plain versions run here on the CPU), against the JAX
package, with inputs made from numpy seeds:

- K1's and K4's plain version (``ag.ag_reference``: each rule's adjoint
  over the model's torch function and ``torch.func.vjp``) under each rule
  × rf kind, with the parameters estimated and fixed (NaKL also without
  its stimulus), against the XLA action in f64: A, the combined K4 value
  and the gradient to 1e-12;
- one case a model against the reference's K1 (``make_action_ag``,
  Pallas interpret mode) in f32 (2e-5: the two sum in other orders);
- the envelope: the three models in, each rule and rf kind, f32 and f64;
  a user model (ROADMAP.md §2a item 2 (f)), the log-space NaKL model
  (reference fault 7) and repeated observed columns (reference fault 6)
  refused, each naming its condition;
- ``test_reference_k1_log_model_fault``: the reference's ``ag_supported``
  takes the log-space model and its launch raises.

The problems are tests/test_torch_nakl.py's and tests/test_torch_colpitts.py's
(N = 18 data rows)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu import models as models_jax
from varanneal_tpu.kernels import ag_pallas
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax

from varanneal_tpu_torch import models
from varanneal_tpu_torch.kernels import ag
from varanneal_tpu_torch.ops import build_spec
from varanneal_tpu_torch.ops.spec import spec_from_reference

from tests import test_torch_colpitts as tc
from tests import test_torch_nakl as tn

DISCS = ("trapezoid", "euler", "forwardmap", "SimpsonHermite")
MODELS = ("nakl", "colpitts", "l63")
PIDX = {"nakl": (1, 2, 3, 4, 5), "colpitts": (0, 1, 2, 3), "l63": (0, 2)}


@pytest.fixture(autouse=True)
def _interpret():
    ag_pallas.set_interpret(True)
    yield
    ag_pallas.set_interpret(False)


def _no_stim(sj, ft):
    """The same NaKL problem without its stimulus, in both packages."""
    sj = dataclasses.replace(sj, stim_f=None)
    return sj, spec_from_reference(dataclasses.asdict(sj), ft)


def problem(model, disc, pidx=None, stim=True, B=2, seed=3):
    """(JAX spec, port spec, decision vectors (B, n_dof) near the path,
    the estimated parameters 5 % off their base values)."""
    pidx = PIDX[model] if pidx is None else pidx
    if model == "nakl":
        sj, st, tw = tn._specs(disc, pidx)
        if not stim:
            sj, st = _no_stim(sj, models.nakl)
        X, pest = tn._draw(st, tw, seed, B=B)
    else:
        sj, st, traj = tc._specs(model, disc, pidx)
        X, pest = tc._draw(st, traj, seed, B=B)
    Z = np.concatenate([X.reshape(B, st.n_state), pest], axis=1)
    return sj, st, Z


def _rf(kind, st, seed=4):
    if kind == "scalar":
        return 2e-3
    return np.random.default_rng(seed).uniform(0.5, 2.0, (st.N_f - 1, st.D))


def _jax_vag(action, Z, rf):
    return map(np.asarray, jax.vmap(jax.value_and_grad(
        lambda u: action(u, rf)))(jnp.asarray(Z)))


def _close(A, G, A_ref, G_ref, tol):
    np.testing.assert_allclose(np.asarray(A), A_ref, rtol=tol)
    scale = np.abs(G_ref).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(G) / scale, G_ref / scale,
                               rtol=0, atol=tol)


CASES = [(m, d, k) for m in MODELS for d in DISCS for k in ("scalar", "diag")]


@pytest.mark.parametrize("model,disc,rf_kind", CASES)
def test_plain_k1_k4_match_xla(model, disc, rf_kind):
    """K1's plain version and K4's combined value in f64 against the XLA
    action (1e-12 of A and of max|g|), the parameters estimated and
    fixed; NaKL also without its stimulus."""
    variants = [dict(), dict(pidx=())]
    if model == "nakl":
        variants.append(dict(stim=False, pidx=tuple(range(19))))
    for kw in variants:
        sj, st, Z = problem(model, disc, **kw)
        rf = _rf(rf_kind, st)
        assert ag.ag_refusal(st, rf, torch.float64) is None
        A_x, G_x = _jax_vag(make_action_jax(sj)[0], Z, jnp.asarray(rf))
        c = ag.ag_consts(st, "cpu", torch.float64)
        rf_t = rf if np.ndim(rf) == 0 else torch.tensor(rf)
        A, G, C = ag.ag_reference(torch.tensor(Z), rf_t, c,
                                  compensated=True)
        _close(A.numpy(), G.numpy(), A_x, G_x, 1e-12)
        np.testing.assert_allclose(ag.combine(C, rf_t, c).numpy(), A_x,
                                   rtol=1e-12)
        assert (C[:, 4:] != 0).any() == (disc == "SimpsonHermite")


@pytest.mark.parametrize("model,disc,rf_kind", [
    ("nakl", "SimpsonHermite", "diag"), ("colpitts", "trapezoid", "scalar"),
    ("l63", "forwardmap", "diag")])
def test_plain_k1_matches_reference_k1(model, disc, rf_kind):
    """One case a model: K1's plain version in f32 against the reference's
    K1 (``ag_pallas.make_action_ag`` in interpret mode), 2e-5 of A and of
    max|g|."""
    sj, st, Z = problem(model, disc)
    rf = np.asarray(_rf(rf_kind, st), np.float32)
    assert ag_pallas.ag_supported(sj, rf)
    act, _ = ag_pallas.make_action_ag(sj)
    A_p, G_p = _jax_vag(act, Z.astype(np.float32), jnp.asarray(rf))
    c = ag.ag_consts(st, "cpu", torch.float32)
    A, G = ag.ag_reference(torch.tensor(Z, dtype=torch.float32),
                           torch.tensor(rf) if rf.ndim else float(rf), c)
    _close(A.numpy(), G.numpy(), A_p, G_p, 2e-5)


def test_envelope_and_refusals():
    """The three models under each rule and rf kind, f32 and f64, are in
    K1's envelope (K4's too); a user model names §2a item 2 (f), the
    log-space NaKL model reference fault 7, repeated observed columns
    fault 6, a per-member rf its shape, and make_action_ag raises outside
    the envelope."""
    for model in MODELS:
        for disc in DISCS:
            sj, st, _ = problem(model, disc, B=1)
            for kind in ("scalar", "diag"):
                for dt in (torch.float32, torch.float64):
                    assert ag.ag_refusal(st, _rf(kind, st), dt) is None
                    assert ag.ag_supported(st, _rf(kind, st), dt, True)
            assert "rf of shape" in ag.ag_refusal(
                st, np.ones((2, st.N_f - 1, st.D)))
    sj, st, _ = problem("nakl", "trapezoid", B=1)
    user = dataclasses.replace(st, f=lambda t, x, p: models.nakl(t, x, p))
    assert "§2a item 2 (f)" in ag.ag_refusal(user, 1.0)
    log_f = models.nakl_log_model(tn.LOG_IDX)[0]
    log = dataclasses.replace(st, f=log_f)
    assert "fault 7" in ag.ag_refusal(log, 1.0)
    rep = build_spec(models.lorenz63, 3, np.zeros((5, 2)),
                     0.01 * np.arange(5), [0, 0], 1.0,
                     P=np.array([10.0, 28.0, 8 / 3]), pidx=[0])
    assert "fault 6" in ag.ag_refusal(rep, 1.0)
    l63_stim = dataclasses.replace(
        problem("l63", "euler", B=1)[1], stim_f=np.zeros((35, 1)))
    assert "Lorenz-63 with a stimulus" in ag.ag_refusal(l63_stim, 1.0)
    for sp in (user, log, rep):
        assert not ag.ag_supported(sp, 1.0)
        with pytest.raises(ValueError, match="envelope"):
            ag.make_action_ag(sp, device="cpu")


def test_reference_k1_log_model_fault():
    """Reference fault 7 (ROADMAP.md §3): the reference's ``ag_supported``
    takes the log-space NaKL model, and its K1 cannot launch it
    (``pallas_call`` refuses a kernel that captures the model's index
    array); the port's K1 refuses the model and names the fault."""
    tw = tn.twin_jax.nakl_twin(N=18, dt=0.04, sigma=1.0, seed=7, seg=8)
    fj, P = models_jax.nakl_log_model(tn.LOG_IDX)
    sj = build_spec_jax(fj, 4, tw["V"], tw["t"], [0], 1.0, disc="trapezoid",
                        P=P, pidx=list(range(1, 19)), stim=tw["stim"])
    assert ag_pallas.ag_supported(sj, np.float32(1.0))
    act, _ = ag_pallas.make_action_ag(sj)
    st = spec_from_reference(dataclasses.asdict(sj),
                             models.nakl_log_model(tn.LOG_IDX)[0])
    Z = np.zeros((1, st.n_dof), np.float32)
    with pytest.raises(Exception, match="captures constants"):
        _jax_vag(act, Z, jnp.float32(1.0))
    assert "fault 7" in ag.ag_refusal(st, 1.0)
