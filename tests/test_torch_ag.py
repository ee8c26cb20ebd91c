"""K1's plain version (varanneal_tpu_torch/kernels/ag.py::ag_reference,
the hand adjoint the CUDA kernel implements) against the JAX fused kernel
``make_action_ag`` run in Pallas interpret mode (f32, rtol 2e-5: the two
sum in different orders), the JAX XLA action in f64 (1e-12) and the
native C++ analytic gradient (1e-12). Also: the wrapper's envelope, its
CPU dispatch and its autograd Function. The CUDA launch itself is checked
on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu import native
from varanneal_tpu.kernels import ag_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax
from varanneal_tpu.twin import lorenz96_twin

from varanneal_tpu_torch.kernels import ag
from varanneal_tpu_torch.models import lorenz96, lorenz63
from varanneal_tpu_torch.ops import build_spec, pack, make_action


@pytest.fixture(autouse=True)
def _interpret():
    ag_pallas.set_interpret(True)
    yield
    ag_pallas.set_interpret(False)


def _specs(N=41, RM=None, pidx=(0,), dt_model=None):
    tw = lorenz96_twin(D=20, N_data=N, n_obs=8, spin=300)
    kw = dict(disc="trapezoid", P=np.array([4.0]), pidx=list(pidx),
              dt_model=dt_model)
    RM = tw["RM"] if RM is None else RM
    sj = build_spec_jax(lorenz96_jax, 20, tw["Y"], tw["t"], tw["Lidx"], RM,
                        **kw)
    st = build_spec(lorenz96, 20, tw["Y"], tw["t"], tw["Lidx"], RM, **kw)
    return sj, st, tw


def _draw(spec, tw, rng, B):
    """Data-informed draws (as tests/test_ag_pallas.py makes them):
    observed entries from the data, unobserved near the attractor's
    scale, F near its truth."""
    out = []
    for _ in range(B):
        X = rng.normal(2.0, 2.0, (spec.N_f, spec.D))
        rows = np.arange(spec.N_data) * spec.obs_stride
        X[np.ix_(rows, np.asarray(spec.Lidx))] = tw["Y"] + rng.normal(
            0, 0.3, tw["Y"].shape)
        out.append(pack(spec, X, np.array([4.0 + rng.normal()])))
    return np.stack(out)


def test_reference_matches_jax_ag_kernel_f32():
    rng = np.random.default_rng(1)
    sj, st, tw = _specs()
    Z = _draw(st, tw, rng, 3).astype(np.float32)
    act_p, _ = ag_pallas.make_action_ag(sj)
    for rf in (1e-3, 3.0, 1e4):
        vag = jax.vmap(jax.value_and_grad(lambda u: act_p(u, np.float32(rf))))
        vp, gp = map(np.asarray, vag(jnp.asarray(Z)))
        c = ag.ag_consts(st, "cpu", torch.float32)
        vt, gt = ag.ag_reference(torch.tensor(Z), rf, c)
        np.testing.assert_allclose(vt.numpy(), vp, rtol=2e-5)
        scale = np.abs(gp).max(axis=-1, keepdims=True)
        np.testing.assert_allclose(gt.numpy() / scale, gp / scale,
                                   atol=2e-5)


@pytest.mark.parametrize("RM,pidx,dt_model", [
    (None, (0,), None),            # scalar RM, F estimated
    ("diag", (0,), None),          # (N_data, L) RM
    (None, (), None),              # F fixed
    (None, (0,), 0.0125),          # observation stride 2
])
def test_reference_matches_jax_action_f64(RM, pidx, dt_model):
    rng = np.random.default_rng(2)
    if RM == "diag":
        RM = rng.uniform(0.5, 2.0, (21, 8))
    sj, st, tw = _specs(N=21, RM=RM, pidx=pidx, dt_model=dt_model)
    Z = _draw(st, tw, rng, 3)
    act_j, _ = make_action_jax(sj)
    c = ag.ag_consts(st, "cpu", torch.float64)
    for rf in (1e-3, 3.0, 1e4):
        vj, gj = map(np.asarray, jax.vmap(jax.value_and_grad(
            lambda u: act_j(u, rf)))(jnp.asarray(Z)))
        vt, gt = ag.ag_reference(torch.tensor(Z), rf, c)
        np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-12)
        scale = np.abs(gj).max(axis=-1, keepdims=True)
        np.testing.assert_allclose(gt.numpy() / scale, gj / scale,
                                   rtol=0, atol=1e-12)


def test_reference_matches_native_cpp():
    if not native.available():
        pytest.skip("native C++ oracle does not build here (no g++)")
    rng = np.random.default_rng(3)
    sj, st, tw = _specs(N=21)
    Z = _draw(st, tw, rng, 2)
    c = ag.ag_consts(st, "cpu", torch.float64)
    vt, gt = ag.ag_reference(torch.tensor(Z), 5.0, c)
    for b in range(2):
        a_n, g_n = native.l96_trap_action_grad(
            Z[b], st.N_f, st.D, st.Y, st.Lidx, st.obs_stride,
            float(st.RM), 5.0, st.dt)
        np.testing.assert_allclose(vt[b].item(), a_n, rtol=1e-12)
        scale = np.abs(g_n).max()
        np.testing.assert_allclose(gt[b].numpy() / scale, g_n / scale,
                                   rtol=0, atol=1e-12)


def test_wrapper_dispatch_and_autograd_on_cpu():
    rng = np.random.default_rng(4)
    sj, st, tw = _specs(N=21)
    Z = torch.tensor(_draw(st, tw, rng, 2))
    action, parts = ag.make_action_ag(st, device="cpu", dtype=torch.float64)
    before = ag.LAUNCHES
    A, G = action.value_and_grad(Z, 2.0)
    assert ag.LAUNCHES == before            # the CPU path launches nothing
    A_ref, _, _ = parts(Z, 2.0)
    np.testing.assert_allclose(A.numpy(), A_ref.numpy(), rtol=1e-12)
    z = Z.clone().requires_grad_(True)
    (3.0 * action(z, 2.0).sum()).backward()
    np.testing.assert_allclose(z.grad.numpy(), 3.0 * G.numpy(), rtol=1e-15)
    with pytest.raises(ValueError, match="scalar rf"):
        action.value_and_grad(Z, torch.ones(st.N_f - 1, st.D))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ag.make_action_ag(st)


def test_envelope():
    sj, st, tw = _specs(N=21)
    assert ag.ag_supported(st, 1.0)
    assert not ag.ag_supported(st, np.ones((st.N_f - 1, st.D)))
    rng = np.random.default_rng(5)
    kw = dict(P=np.array([4.0]), pidx=[0])
    Y, t, Lidx = tw["Y"], tw["t"], tw["Lidx"]
    others = [
        build_spec(lorenz96, 20, Y, t, Lidx, 4.0, disc="euler", **kw),
        build_spec(lorenz96, 20, Y, t, Lidx, 4.0, disc="SimpsonHermite",
                   **kw),
        build_spec(lorenz96, 20, Y, t, Lidx, rng.uniform(1, 2, (8, 8)),
                   disc="trapezoid", R_time_dependent=False, **kw),
        build_spec(lorenz96, 20, Y, t, Lidx, 4.0, disc="trapezoid",
                   P=rng.uniform(7, 9, (21, 1)), pidx=[0]),
        build_spec(lorenz63, 3, Y[:, :2], t, [0, 1], 4.0, disc="trapezoid",
                   P=np.array([10.0, 28.0, 8 / 3]), pidx=[0]),
        build_spec(lambda tt, x, p: lorenz96(tt, x, p), 20, Y, t, Lidx,
                   4.0, disc="trapezoid", **kw),
    ]
    for sp in others:
        assert not ag.ag_supported(sp, 1.0)
        with pytest.raises(ValueError, match="envelope"):
            ag.make_action_ag(sp, device="cpu")
    # shared memory: (N_f - 1) * D residuals must fit one block's 227 KB
    N = 1500
    big = build_spec(lorenz96, 20, rng.normal(size=(N, 8)),
                     0.025 * np.arange(N), Lidx, 4.0, **kw)
    assert ag.ag_supported(big, 1.0, torch.float32)
    assert not ag.ag_supported(big, 1.0, torch.float64)
    # the plain action serves every problem outside the envelope
    a, _ = make_action(others[0], device="cpu")
    assert torch.isfinite(a(torch.zeros(1, others[0].n_dof,
                                        dtype=torch.float64), 1.0)).all()
