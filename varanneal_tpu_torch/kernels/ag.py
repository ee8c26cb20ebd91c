"""K1: the fused Lorenz-96 action + gradient, one launch per evaluation.

Counterpart of ``varanneal_tpu/kernels/ag_pallas.py`` (``ag_supported``,
``embed_consts``, ``make_action_ag``), whose ``_ag_kernel`` this replaces
on the card with the hand-written CUDA kernel in ``csrc/ag_kernel.cu``
(the source notes what bounds it and what its design does about that).
Beside the kernel this module holds:

- :func:`ag_reference`, a plain PyTorch version that spells out the same
  hand adjoint (f, Jᵀv, the two-residual gradient) rather than calling
  autograd, so the CPU tests check the arithmetic the CUDA code does;
- :data:`LAUNCHES`, a plain count of kernel launches;
- :func:`ag_supported`, the kernel's envelope.

:func:`action_and_grad` takes the plain version only for tensors on the
CPU. For a CUDA tensor it launches the kernel or raises; it never falls
back.
"""

import ctypes
import dataclasses

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.models.lorenz import lorenz96
from varanneal_tpu_torch.ops import action as _action
from varanneal_tpu_torch.ops.spec import ProblemSpec

#: Kernel launches so far; each successful launch adds one.
LAUNCHES = 0

#: Shared memory one H100 block can opt into (227 KB).
SMEM_LIMIT = 232448
_THREADS = 256          # kThreads in csrc/ag_kernel.cu
_DTYPES = (torch.float32, torch.float64)


def _smem_bytes(N_f, D, dtype):
    return ((N_f - 1) * D + 3 * (_THREADS // 32)) * (
        torch.finfo(dtype).bits // 8)


def _uniform_grid(spec: ProblemSpec) -> bool:
    t_f = np.asarray(spec.t_f)
    ref = t_f[0] + spec.dt * np.arange(t_f.shape[0])
    return bool(np.allclose(t_f, ref, rtol=1e-12, atol=1e-9))


def ag_supported(spec: ProblemSpec, rf=0.0, dtype=torch.float32) -> bool:
    """The kernel's envelope: trapezoid rule, Lorenz-96 (the port's
    ``models.lorenz.lorenz96``) with constant parameters and no stimulus,
    F estimated or fixed, scalar rf, scalar or (N_data, L) RM, a uniform
    grid, f32 or f64, and the (N_f-1, D) residuals fitting in one block's
    shared memory."""
    NP = spec.NP
    return (spec.disc == "trapezoid"
            and spec.f is lorenz96
            and spec.D >= 4
            and not spec.time_dep_p
            and spec.stim_f is None
            and NP == 1
            and spec.pidx in ((), (0,))
            and np.ndim(rf) == 0
            and np.ndim(spec.RM) in (0, 2)
            and dtype in _DTYPES
            and _uniform_grid(spec)
            and _smem_bytes(spec.N_f, spec.D, dtype) <= SMEM_LIMIT)


@dataclasses.dataclass(frozen=True)
class AgConsts:
    """The kernel's constants for one problem, on one device and dtype
    (the counterpart of ``embed_consts``: no padding or embedding, since
    the kernel reads X straight from the flat decision vector)."""
    N: int
    D: int
    n_state: int
    n_dof: int
    pslot: int              # index of F in XP, or -1 when F is fixed
    F_fixed: float
    obs_stride: int
    N_data: int
    L: int
    h: float
    me_norm: float
    fe_norm: float
    Y: torch.Tensor         # (N_data, L)
    W: torch.Tensor         # (N_data, L) RM weights
    lidx: torch.Tensor      # (L,) int32 observed columns
    lpos: torch.Tensor      # (D,) int32 position in lidx, or -1
    obs_rows: torch.Tensor  # (N_data,) int64 observed model rows
    device: torch.device
    dtype: torch.dtype


def ag_consts(spec: ProblemSpec, device, dtype) -> AgConsts:
    """Build :class:`AgConsts` for ``spec`` (which must be supported)."""
    if not ag_supported(spec, 0.0, dtype):
        raise ValueError("problem outside the ag kernel's envelope (see "
                         "ag_supported); use ops.action.make_action")
    L = spec.L
    RM = np.asarray(spec.RM, np.float64)
    W = np.broadcast_to(RM, (spec.N_data, L)) if RM.ndim == 0 else RM
    lpos = np.full(spec.D, -1, np.int32)
    lpos[list(spec.Lidx)] = np.arange(L, dtype=np.int32)

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    return AgConsts(
        N=spec.N_f, D=spec.D, n_state=spec.n_state, n_dof=spec.n_dof,
        pslot=spec.n_state if spec.NPest else -1,
        F_fixed=float(np.asarray(spec.P_base)[0]),
        obs_stride=spec.obs_stride, N_data=spec.N_data, L=L, h=spec.dt,
        me_norm=1.0 / (L * spec.N_data),
        fe_norm=1.0 / (spec.D * (spec.N_f - 1)),
        Y=t(spec.Y, dtype), W=t(W, dtype),
        lidx=t(np.asarray(spec.Lidx, np.int32), torch.int32),
        lpos=t(lpos, torch.int32),
        obs_rows=t(np.arange(spec.N_data) * spec.obs_stride, torch.int64),
        device=resolve_device(device), dtype=dtype)


def _scalar(v, dtype):
    """A Python float rounded to ``dtype``, as the kernel receives it."""
    return float(torch.tensor(float(v), dtype=dtype))


def _roll(x, k):
    return torch.roll(x, k, dims=-1)


def ag_reference(XP, rf, c: AgConsts):
    """Plain PyTorch action and gradient with the kernel's hand adjoint.
    ``XP`` (B, n_dof) -> (A (B,), dA/dXP (B, n_dof))."""
    B = XP.shape[0]
    dt = XP.dtype
    X = XP[:, : c.n_state].reshape(B, c.N, c.D)
    F = (XP[:, c.pslot].reshape(B, 1, 1) if c.pslot >= 0
         else _scalar(c.F_fixed, dt))
    h = _scalar(c.h, dt)
    hh = _scalar(h / 2.0, dt)
    rf = _scalar(rf, dt)
    me_norm = _scalar(c.me_norm, dt)
    fe_norm = _scalar(c.fe_norm, dt)

    # forward: residuals, FE, sum r, ME
    f = (_roll(X, -1) - _roll(X, 2)) * _roll(X, 1) - X + F
    r = X[:, 1:] - X[:, :-1] - hh * (f[:, :-1] + f[:, 1:])
    fe = torch.sum(r * r, dim=(1, 2))
    sr = torch.sum(r, dim=(1, 2))
    diff = X[:, c.obs_rows][:, :, c.lidx.long()] - c.Y
    me = torch.sum(c.W * diff * diff, dim=(1, 2))
    A = me_norm * me + fe_norm * (rf * fe)

    # adjoint: gX_n = 2c [r_{n-1} - r_n - (h/2) J(x_n)^T (r_{n-1} + r_n)]
    zero = torch.zeros_like(r[:, :1])
    rp = torch.cat([zero, r], dim=1)          # r_{n-1}, zero at n = 0
    rc = torch.cat([r, zero], dim=1)          # r_n, zero at n = N-1
    v = rp + rc
    jtv = (_roll(X, 2) * _roll(v, 1)
           + (_roll(X, -2) - _roll(X, 1)) * _roll(v, -1)
           - _roll(X, -1) * _roll(v, -2)
           - v)
    c2 = 2.0 * fe_norm * rf
    gX = c2 * (rp - rc - hh * jtv)
    gX[:, c.obs_rows[:, None], c.lidx.long()[None, :]] += (
        2.0 * me_norm * c.W * diff)
    parts = [gX.reshape(B, c.n_state)]
    if c.pslot >= 0:
        parts.append((-c2 * h * sr)[:, None])
    return A, torch.cat(parts, dim=1)


def _lib():
    from varanneal_tpu_torch.kernels import _build
    lib = _build.load("ag_kernel").lib
    if not getattr(lib, "_va_typed", False):
        P, I, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.va_l96_ag_trap_f32, lib.va_l96_ag_trap_f64):
            fn.restype = I
            fn.argtypes = [P, I, I, I, I, I, Dbl, P, P, P, P, I, I, I,
                           Dbl, Dbl, Dbl, Dbl, P, P, P]
        lib.va_cuda_error_string.restype = ctypes.c_char_p
        lib.va_cuda_error_string.argtypes = [I]
        lib._va_typed = True
    return lib


def ag_kernel(XP, rf, c: AgConsts):
    """Launch the CUDA kernel on ``XP`` (B, n_dof), a contiguous CUDA
    tensor of ``c``'s dtype on ``c``'s device. Returns (A, dA/dXP) on
    PyTorch's current stream, without synchronizing. Raises on anything
    the kernel does not take and on a refused launch."""
    global LAUNCHES
    if XP.device.type != "cuda" or XP.device != c.device:
        raise ValueError(f"XP is on {XP.device}; the kernel's constants "
                         f"are on {c.device}")
    if XP.dtype != c.dtype or XP.ndim != 2 or XP.shape[1] != c.n_dof:
        raise ValueError(f"XP must be (B, {c.n_dof}) {c.dtype}; got "
                         f"{tuple(XP.shape)} {XP.dtype}")
    XP = XP.contiguous()
    B = XP.shape[0]
    A = torch.empty(B, dtype=c.dtype, device=XP.device)
    G = torch.empty_like(XP)
    if B == 0:
        return A, G
    lib = _lib()
    fn = (lib.va_l96_ag_trap_f32 if c.dtype == torch.float32
          else lib.va_l96_ag_trap_f64)
    with torch.cuda.device(XP.device):
        stream = torch.cuda.current_stream(XP.device).cuda_stream
        rc = fn(XP.data_ptr(), B, c.n_dof, c.N, c.D, c.pslot, c.F_fixed,
                c.Y.data_ptr(), c.W.data_ptr(), c.lidx.data_ptr(),
                c.lpos.data_ptr(), c.N_data, c.L, c.obs_stride, c.h,
                float(rf), c.me_norm, c.fe_norm, A.data_ptr(),
                G.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"ag kernel launch failed: cudaError {rc} "
            f"({lib.va_cuda_error_string(rc).decode()})")
    LAUNCHES += 1
    return A, G


def action_and_grad(XP, rf, c: AgConsts):
    """(A, dA/dXP) for ``XP`` (..., n_dof): the plain version for a CPU
    tensor, the kernel for a CUDA tensor."""
    if np.ndim(rf) != 0:
        raise ValueError("the ag kernel takes a scalar rf only")
    lead = tuple(XP.shape[:-1])
    XP2 = XP.reshape(-1, c.n_dof)
    if XP.device.type == "cpu":
        if XP.device != c.device:
            raise ValueError(f"XP is on {XP.device}; the constants are on "
                             f"{c.device}")
        A, G = ag_reference(XP2, rf, c)
    else:
        A, G = ag_kernel(XP2, rf, c)
    return A.reshape(lead), G.reshape(lead + (c.n_dof,))


class _AgAction(torch.autograd.Function):
    """The action with the kernel's gradient saved by the forward; the
    backward only scales it (``ag_pallas.py``'s ``action_bwd``)."""

    @staticmethod
    def forward(ctx, XP, rf, c):
        A, G = action_and_grad(XP, rf, c)
        ctx.save_for_backward(G)
        return A

    @staticmethod
    def backward(ctx, gA):
        (G,) = ctx.saved_tensors
        return gA[..., None] * G, None, None


def make_action_ag(spec: ProblemSpec, device=None, dtype=torch.float32):
    """Build ``(action, action_parts)`` with the fused kernel.
    ``action(XP, rf)`` is differentiable by autograd and carries
    ``action.value_and_grad(XP, rf) -> (A, dA/dXP)``, one launch for both,
    which the solver calls directly. ``action_parts`` is the plain action
    (``ops.action``), used once per rung for the records. ``device=None``
    means the CUDA card. Raises ValueError outside :func:`ag_supported`."""
    device = resolve_device(device)
    c = ag_consts(spec, device, dtype)

    def action(XP, rf):
        return _AgAction.apply(XP, rf, c)

    def value_and_grad(XP, rf):
        return action_and_grad(XP, rf, c)

    action.value_and_grad = value_and_grad
    action.consts = c
    _, parts = _action.make_action(spec, device=device)
    return action, parts
