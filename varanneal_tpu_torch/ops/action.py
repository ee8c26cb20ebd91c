"""The Gaussian VA action in PyTorch: measurement error + annealed model
error, with gradients from torch autograd.

Counterpart of ``varanneal_tpu/ops/action.py`` (``pack``,
``merge_params``, ``unpack``, ``_quad``, ``measurement_error``,
``model_error``, ``make_action``), with the same normalizations:

    A(XP, rf) = ME(X) + FE(X, P; rf)
    ME = (1 / (L * N_data))    * sum_n sum_{l in Lidx} RM ⊙ (x_l(t_n) - y_l(t_n))^2
    FE = (1 / (D * (N_f - 1))) * sum over residual rows of rf ⊙ g^2

with RM in {scalar, (N_data, L), (N_data, L, L)} and rf in
{scalar, (N_f-1, D), (N_f-1, D, D)}; under Hermite–Simpson even rf rows
weight the Simpson residuals and odd rows the Hermite ones.

The decision vector is batched: ``XP`` is ``(..., n_dof)`` and the action
returns one value per leading index. In the port this action serves the
per-rung records (``action_parts``), the f64 tail and every problem
outside the fused kernel's envelope (``kernels/ag.py``). The compensated
(two-float) sums and the structured-tree variants wait for a later slice.
"""

import dataclasses

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.ops.spec import ProblemSpec
from varanneal_tpu_torch.ops.disc import model_residuals


def pack(spec: ProblemSpec, X, P=None):
    """Flatten (X, estimated-parameter values) into the decision vector XP:
    row-major X (..., N_f, D) then the estimated parameters (row-major
    (N_f, NPest) in the time-dependent case), shared by every leading
    index. NumPy in, NumPy out; tensor in, tensor out."""
    lead = tuple(X.shape[:-2])
    Xf = X.reshape(lead + (spec.n_state,))
    if not spec.NPest:
        return Xf
    P = np.asarray(spec.P_base if P is None else P)
    pe = P[..., list(spec.pidx)].reshape(-1)
    if isinstance(X, torch.Tensor):
        pe = torch.as_tensor(pe, dtype=X.dtype, device=X.device)
        return torch.cat([Xf, pe.expand(lead + pe.shape)], dim=-1)
    return np.concatenate([Xf, np.broadcast_to(pe, lead + pe.shape)],
                          axis=-1)


def merge_params(spec: ProblemSpec, pest):
    """Merge estimated parameter values ``pest`` (..., n_par) into the fixed
    base values. Returns (..., 1, NP) for constant parameters (the singleton
    row broadcasts over time) or (..., N_f, NP) for time-dependent ones.
    ``spec.P_base`` must already be a tensor on ``pest``'s device."""
    lead = tuple(pest.shape[:-1])
    P = spec.P_base.to(pest.dtype)
    if not spec.time_dep_p:
        P = P.reshape(1, spec.NP)
    P = P.expand(lead + tuple(P.shape)).clone()
    if spec.NPest:
        pcols = list(spec.pidx)
        if spec.time_dep_p:
            P[..., pcols] = pest.reshape(lead + (spec.N_f, spec.NPest))
        else:
            P[..., 0, pcols] = pest
    return P


def unpack(spec: ProblemSpec, XP):
    """Split flat XP (..., n_dof) into X (..., N_f, D) and the full
    parameter array (see :func:`merge_params`)."""
    lead = tuple(XP.shape[:-1])
    X = XP[..., : spec.n_state].reshape(lead + (spec.N_f, spec.D))
    P = merge_params(spec, XP[..., spec.n_state:])
    return X, P


def _quad(R, d):
    """Quadratic contraction of R against residual rows d (..., N, K),
    summed over the last two axes: scalar -> R * sum(d^2); (N, K) ->
    sum(R * d^2); (N, K, K) -> sum_n d_n . R_n . d_n."""
    if not isinstance(R, torch.Tensor) or R.ndim == 0:
        return R * torch.sum(d * d, dim=(-2, -1))
    if R.ndim == 2:
        return torch.sum(R * d * d, dim=(-2, -1))
    return torch.einsum("...nk,nkl,...nl->...", d, R, d)


def measurement_error(spec: ProblemSpec, X):
    """ME = (1/(L*N_data)) * quad(RM, x_obs - Y); ``spec``'s arrays must be
    tensors on X's device (see :func:`device_spec`)."""
    x_obs = X[..., :: spec.obs_stride, :][..., : spec.N_data, :]
    x_obs = x_obs[..., list(spec.Lidx)]
    diff = x_obs - spec.Y
    return _quad(spec.RM, diff) / (spec.L * spec.N_data)


def model_error(spec: ProblemSpec, X, P, rf):
    """FE = (1/(D*(N_f-1))) * quad(rf, residual rows)."""
    res = model_residuals(spec, X, P)
    if spec.disc == "SimpsonHermite":
        simpson, hermite = res
        if not isinstance(rf, torch.Tensor) or rf.ndim == 0:
            ferr = rf * (torch.sum(simpson * simpson, dim=(-2, -1))
                         + torch.sum(hermite * hermite, dim=(-2, -1)))
        else:
            M = (spec.N_f - 1) // 2
            ferr = (_quad(rf[: 2 * M: 2], simpson)
                    + _quad(rf[1: 2 * M: 2], hermite))
    else:
        ferr = _quad(rf, res)
    return ferr / (spec.D * (spec.N_f - 1))


def device_spec(spec: ProblemSpec, device, dtype) -> ProblemSpec:
    """``spec`` with its array fields as ``dtype`` tensors on ``device``,
    made once so that no evaluation copies constants from the host."""
    def t(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, dtype=np.float64), device=device).to(dtype)
    return dataclasses.replace(
        spec, t_f=t(spec.t_f), Y=t(spec.Y), stim_f=t(spec.stim_f),
        P_base=t(spec.P_base), RM=t(spec.RM))


def rf_arg(rf, dtype, device):
    """The annealed precision as the action takes it: a Python float
    rounded to ``dtype`` for a scalar (no device copy), else a tensor."""
    if isinstance(rf, torch.Tensor):
        if rf.ndim == 0 and rf.device.type == "cpu":
            return float(rf.to(dtype))
        return rf.to(device=device, dtype=dtype)
    arr = np.asarray(rf, dtype=np.float64)
    if arr.ndim == 0:
        return float(torch.tensor(float(arr), dtype=dtype))
    return torch.as_tensor(arr, device=device).to(dtype)


def make_action(spec: ProblemSpec, device=None):
    """Build ``(action, action_parts)`` on the flat batched decision vector:
    ``action(XP, rf) -> A`` and ``action_parts(XP, rf) -> (A, ME, FE)``,
    each of shape ``XP.shape[:-1]``. Gradients come from torch autograd
    (see :func:`value_and_grad`). ``device=None`` means the CUDA card."""
    device = resolve_device(device)
    cache = {}

    def consts(dtype):
        if dtype not in cache:
            cache[dtype] = device_spec(spec, device, dtype)
        return cache[dtype]

    def action_parts(XP, rf):
        if XP.device != device:
            raise ValueError(f"XP is on {XP.device}, the action on {device}")
        sp = consts(XP.dtype)
        X, P = unpack(sp, XP)
        me = measurement_error(sp, X)
        fe = model_error(sp, X, P, rf_arg(rf, XP.dtype, device))
        return me + fe, me, fe

    def action(XP, rf):
        return action_parts(XP, rf)[0]

    return action, action_parts


def value_and_grad(action):
    """``vag(XP, rf) -> (A, dA/dXP)`` for a batched action. An action that
    carries its own ``value_and_grad`` (the fused kernel's, which computes
    both in one launch) is used as is; any other goes through autograd.
    Members are independent, so the gradient of the summed action is each
    member's own gradient."""
    own = getattr(action, "value_and_grad", None)
    if own is not None:
        return own

    def vag(XP, rf):
        with torch.enable_grad():
            x = XP.detach().requires_grad_(True)
            f = action(x, rf)
            (g,) = torch.autograd.grad(f.sum(), x)
        return f.detach(), g

    return vag
