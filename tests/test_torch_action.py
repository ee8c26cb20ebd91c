"""The port's autograd action (varanneal_tpu_torch/ops/action.py) against
the JAX action (varanneal_tpu/ops/action.py) and the NumPy oracle
(tests/oracle.py), in f64 to 1e-12: value, ME/FE parts and gradient, over
every discretization × scalar / (N, K) / (N, K, K) precision, with the
parameter estimated constant or time-dependent, batched."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax

from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import (build_spec, make_action, pack,
                                     value_and_grad)
from tests.oracle import OracleProblem, lorenz96_np

DISCS = ["euler", "trapezoid", "SimpsonHermite", "forwardmap"]
R_KINDS = [("scalar", "scalar"), ("diag", "diag"), ("mat", "mat"),
           ("scalar", "diag")]


def _problem(disc, rm_kind, rf_kind, time_dep, seed, D=6, N_data=13, L=3):
    rng = np.random.default_rng(seed)
    Lidx = sorted(rng.choice(D, size=L, replace=False).tolist())
    t = 0.025 * np.arange(N_data)
    Y = rng.normal(size=(N_data, L))

    def mk_R(kind, N, K):
        if kind == "scalar":
            return 4.0
        if kind == "diag":
            return rng.uniform(0.5, 2.0, size=(N, K))
        m = rng.normal(size=(N, K, K))
        return np.einsum("nij,nkj->nik", m, m) + 3 * np.eye(K)

    RM = mk_R(rm_kind, N_data, L)
    N_f = 2 * N_data - 1 if disc == "SimpsonHermite" else N_data
    RF = mk_R(rf_kind, N_f - 1, D)
    P = rng.uniform(7.0, 9.0, (N_f, 1)) if time_dep else np.array([8.17])
    kw = dict(disc=disc, P=P, pidx=[0])
    sj = build_spec_jax(lorenz96_jax, D, Y, t, Lidx, RM, **kw)
    st = build_spec(lorenz96, D, Y, t, Lidx, RM, **kw)
    orc = OracleProblem(lorenz96_np, D, Y, t, Lidx, RM, **kw)
    XP = rng.normal(size=(2, st.n_dof))
    return sj, st, orc, XP, RF


@pytest.mark.parametrize("disc", DISCS)
@pytest.mark.parametrize("rm_kind,rf_kind", R_KINDS)
def test_action_and_grad_match_jax_and_oracle(disc, rm_kind, rf_kind):
    seed = DISCS.index(disc) * 10 + R_KINDS.index((rm_kind, rf_kind))
    sj, st, orc, XP, RF = _problem(disc, rm_kind, rf_kind, False, seed)
    act_t, parts_t = make_action(st, device="cpu")
    rf_t = torch.tensor(RF) if np.ndim(RF) else RF
    A_t, g_t = value_and_grad(act_t)(torch.tensor(XP), rf_t)
    _, me_t, fe_t = parts_t(torch.tensor(XP), rf_t)

    act_j, parts_j = make_action_jax(sj)
    vag_j = jax.vmap(jax.value_and_grad(act_j), in_axes=(0, None))
    A_j, g_j = vag_j(jnp.asarray(XP), jnp.asarray(RF))
    _, me_j, fe_j = jax.vmap(parts_j, in_axes=(0, None))(jnp.asarray(XP),
                                                        jnp.asarray(RF))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-12)
    np.testing.assert_allclose(me_t.numpy(), np.asarray(me_j), rtol=1e-12)
    np.testing.assert_allclose(fe_t.numpy(), np.asarray(fe_j), rtol=1e-12)
    scale = np.abs(np.asarray(g_j)).max()
    np.testing.assert_allclose(g_t.numpy() / scale, np.asarray(g_j) / scale,
                               rtol=0, atol=1e-12)
    for b in range(XP.shape[0]):
        a_o, me_o, fe_o = orc.action(XP[b], RF)
        np.testing.assert_allclose(
            [A_t[b].item(), me_t[b].item(), fe_t[b].item()],
            [a_o, me_o, fe_o], rtol=1e-12)


@pytest.mark.parametrize("disc", ["trapezoid", "SimpsonHermite"])
def test_time_dependent_parameters(disc):
    sj, st, orc, XP, RF = _problem(disc, "scalar", "diag", True, 99)
    act_t, _ = make_action(st, device="cpu")
    A_t, g_t = value_and_grad(act_t)(torch.tensor(XP), torch.tensor(RF))
    act_j, _ = make_action_jax(sj)
    A_j, g_j = jax.vmap(jax.value_and_grad(act_j), in_axes=(0, None))(
        jnp.asarray(XP), jnp.asarray(RF))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-12)
    scale = np.abs(np.asarray(g_j)).max()
    np.testing.assert_allclose(g_t.numpy() / scale, np.asarray(g_j) / scale,
                               rtol=0, atol=1e-12)
    for b in range(XP.shape[0]):
        np.testing.assert_allclose(A_t[b].item(), orc.action(XP[b], RF)[0],
                                   rtol=1e-12)


def test_pack_roundtrip_and_device_rule():
    sj, st, orc, XP, RF = _problem("trapezoid", "scalar", "scalar", False, 5)
    X = XP[:, : st.n_state].reshape(2, st.N_f, st.D)
    P = np.array([8.17])
    np.testing.assert_array_equal(pack(st, X[0], P), orc.pack(X[0], P))
    packed = pack(st, torch.tensor(X), P)
    assert packed.shape == (2, st.n_dof)
    np.testing.assert_array_equal(packed[:, -1].numpy(), [8.17, 8.17])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_action(st)
