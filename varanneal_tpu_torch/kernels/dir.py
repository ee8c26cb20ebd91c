"""K7a and K7b: the compact-form L-BFGS direction, and the fused
post-line-search step, one launch each per call.

Counterpart of ``varanneal_tpu/kernels/dir_pallas.py``
(``compact_dir_pallas``, ``fused_step``, ``pallas_dir_supported``), whose
``_dir_kernel`` (K7a) and ``_step_kernel`` (K7b), both built on
``_dir_math``, this replaces on the card with the hand-written CUDA
kernels in ``csrc/dir_kernel.cu`` (the source notes what bounds them and
what their design does about it). Beside the kernels this module holds:

- :func:`compact_dir_reference` and :func:`fused_step_reference`, the
  plain versions: the port's ``opt.lbfgs._compact_dir``, and a step built
  from it with K7b's curvature gate and non-descent fallback;
- :data:`DIR_LAUNCHES` and :data:`STEP_LAUNCHES`, plain counts of kernel
  launches;
- :func:`dir_supported` and :func:`dir_predicate`, the envelope.

The port keeps the history as the joint (B, 2m, n) tensor of
``opt/lbfgs.py`` (rows [0, m) the steps s, rows [m, 2m) the gradient
differences y, a circular buffer written at ``head``). The TPU kernel's
(16, n_pad) augmented block with g as row 2m, its one-hot row
extraction and its lane padding are Mosaic tiling artefacts and have no
counterpart here: the kernels read g, x and the history rows from their
own tensors.

A wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches its kernel or raises; it never falls back.
"""

import ctypes

import torch

from varanneal_tpu_torch.opt.lbfgs import _compact_dir, _dot

#: Launches of the direction kernel (K7a) so far.
DIR_LAUNCHES = 0
#: Launches of the step kernel (K7b) so far.
STEP_LAUNCHES = 0

#: The reference's envelope (``pallas_dir_supported``): 2m + 1 rows in
#: one 16-row tile and n up to 32k. It is the reference's policy for when
#: the fused direction pays, kept so that both packages resolve
#: ``direction`` on the same problems; the CUDA kernels themselves are
#: limited only by m <= 7 (kMaxM in csrc/dir_kernel.cu).
MAX_ROWS = 16
MAX_N = 32 * 1024
MAX_M = 7

#: Columns of K7b's per-member scalar row.
STEP_FIELDS = ("good", "pgn", "gnorm1", "head", "hlen", "sy", "dphi")


def dir_predicate(n, m, dtype) -> bool:
    """The envelope without the device: f32, 1 <= m, 2m + 1 <= 16 rows and
    n <= 32k entries per member."""
    return (dtype == torch.float32 and m >= 1 and 2 * m + 1 <= MAX_ROWS
            and 1 <= n <= MAX_N)


def dir_supported(x, m, dtype=None) -> bool:
    """``direction='auto'`` takes the kernels: ``x`` ((B, n) or (n,)) a CUDA
    tensor inside :func:`dir_predicate`."""
    return (x.device.type == "cuda" and x.ndim in (1, 2)
            and dir_predicate(x.shape[-1], m, dtype or x.dtype))


def compact_dir_reference(g, H, head, hlen):
    """Plain PyTorch K7a: d = -H⁻¹g in the compact form for ``g`` (B, n),
    the joint history ``H`` (B, 2m, n) and ``head``/``hlen`` (B,)."""
    m = H.shape[1] // 2
    return _compact_dir(g, H, None, head.long(), hlen.long(), m)


def fused_step_reference(H, x_old, x_new, g_old, g_new, head, hlen, ls_ok,
                         run):
    """Plain PyTorch K7b for the members where ``run`` holds: the curvature
    gate ``ls_ok & sy > 1e-10·sqrt(s2·y2) & sy > 0``; where it holds, s and
    y written into rows head and m + head of ``H`` and head, hlen
    advanced (``H``, ``head`` and ``hlen`` are updated in place; a member
    where ``run`` fails keeps them bit for bit); the next direction from
    the updated history at g_new, -g_new on non-descent. Returns
    (d (B, n), sc (B, 7)) with sc's columns :data:`STEP_FIELDS`: good,
    max|g_new|, Σ|g_new|, the new head and hlen, sᵀy and g_newᵀd; a
    member where ``run`` fails gets d = 0 and sc = [0, 0, 0, head, hlen,
    0, 0]."""
    dev = H.device
    m = H.shape[1] // 2
    rows = torch.arange(H.shape[0], device=dev)
    ls_ok = torch.as_tensor(ls_ok).to(dev)
    run = torch.as_tensor(run).to(dev)
    sv = x_new - x_old
    yv = g_new - g_old
    sy = _dot(sv, yv)
    s2 = _dot(sv, sv)
    y2 = _dot(yv, yv)
    good = run & ls_ok & (sy > 1e-10 * torch.sqrt(s2 * y2)) & (sy > 0)
    hd = head.long()
    gk = good[:, None]
    H[rows, hd] = torch.where(gk, sv, H[rows, hd])
    H[rows, m + hd] = torch.where(gk, yv, H[rows, m + hd])
    head.copy_(torch.where(good, (hd + 1) % m, hd))
    hlen.copy_(torch.where(good, torch.clamp_max(hlen.long() + 1, m),
                           hlen.long()))
    d = compact_dir_reference(g_new, H, head, hlen)
    desc = _dot(d, g_new)
    bad = (desc >= 0) | ~torch.isfinite(desc)
    d = torch.where(bad[:, None], -1.0 * g_new, d)
    dphi = _dot(g_new, d)
    rk = run[:, None]
    zero = torch.zeros_like(sy)
    sc = torch.stack([
        good.to(sy.dtype),
        torch.where(run, torch.amax(torch.abs(g_new), dim=-1), zero),
        torch.where(run, torch.sum(torch.abs(g_new), dim=-1), zero),
        head.to(sy.dtype), hlen.to(sy.dtype),
        torch.where(run, sy, zero), torch.where(run, dphi, zero)], dim=1)
    return torch.where(rk, d, 0.0), sc


def _lib():
    from varanneal_tpu_torch.kernels import _build
    lib = _build.load("dir_kernel").lib
    if not getattr(lib, "_va_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.va_compact_dir_f32.restype = I
        lib.va_compact_dir_f32.argtypes = [P, P, P, P, I, I, I, P, P]
        lib.va_fused_step_f32.restype = I
        lib.va_fused_step_f32.argtypes = [P, P, P, P, P, P, P, P, I, I, I,
                                          P, P, P]
        lib.va_cuda_error_string.restype = ctypes.c_char_p
        lib.va_cuda_error_string.argtypes = [I]
        lib._va_typed = True
    return lib


def _check(H, vecs, ints):
    if H.device.type != "cuda" or H.dtype != torch.float32 or H.ndim != 3:
        raise ValueError("the direction kernels take a (B, 2m, n) float32 "
                         f"CUDA history; got {tuple(H.shape)} {H.dtype} on "
                         f"{H.device}")
    B, rows, n = H.shape
    m = rows // 2
    if rows != 2 * m or not 1 <= m <= MAX_M:
        raise ValueError(f"the direction kernels take 1 <= m <= {MAX_M}; "
                         f"the history has {rows} rows")
    if not H.is_contiguous():
        raise ValueError("the history must be contiguous (it is updated in "
                         "place)")
    for v in vecs:
        if (v.device != H.device or v.dtype != torch.float32
                or tuple(v.shape) != (B, n)):
            raise ValueError(f"expected (B, n) = {(B, n)} float32 on "
                             f"{H.device}; got {tuple(v.shape)} {v.dtype} on"
                             f" {v.device}")
    for v in ints:
        if (v.device != H.device or v.dtype != torch.int32
                or tuple(v.shape) != (B,) or not v.is_contiguous()):
            raise ValueError(f"head/hlen must be contiguous (B,) = ({B},) "
                             f"int32 on {H.device}")
    return B, m, n


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {rc} "
            f"({lib.va_cuda_error_string(rc).decode()})")


def compact_dir_kernel(g, H, head, hlen):
    """Launch K7a: one block per member. ``g`` (B, n), ``H`` (B, 2m, n)
    float32 and ``head``/``hlen`` (B,) int32, all on one card. Returns d
    (B, n) on PyTorch's current stream, without synchronizing."""
    global DIR_LAUNCHES
    B, m, n = _check(H, (g,), (head, hlen))
    g = g.contiguous()
    d = torch.empty_like(g)
    if B:
        lib = _lib()
        with torch.cuda.device(H.device):
            stream = torch.cuda.current_stream(H.device).cuda_stream
            rc = lib.va_compact_dir_f32(g.data_ptr(), H.data_ptr(),
                                        head.data_ptr(), hlen.data_ptr(), B,
                                        m, n, d.data_ptr(), stream)
        _raise_on(rc, lib, "direction")
        DIR_LAUNCHES += 1
    return d


def fused_step_kernel(H, x_old, x_new, g_old, g_new, head, hlen, ls_ok,
                      run):
    """Launch K7b: one block per member, :func:`fused_step_reference`'s
    function. ``H`` (B, 2m, n), ``head`` and ``hlen`` (B,) int32 are
    updated in place; ``ls_ok`` and ``run`` are (B,) flags, on the host or
    the card. Returns (d (B, n), sc (B, 7)) on PyTorch's current stream,
    without synchronizing."""
    global STEP_LAUNCHES
    B, m, n = _check(H, (x_old, x_new, g_old, g_new), (head, hlen))
    x_old, x_new, g_old, g_new = (v.contiguous()
                                  for v in (x_old, x_new, g_old, g_new))
    flags = torch.stack([torch.as_tensor(ls_ok), torch.as_tensor(run)],
                        dim=1).to(device=H.device, dtype=torch.int32)
    d = torch.empty_like(g_new)
    sc = torch.empty(B, len(STEP_FIELDS), dtype=torch.float32,
                     device=H.device)
    if B:
        lib = _lib()
        with torch.cuda.device(H.device):
            stream = torch.cuda.current_stream(H.device).cuda_stream
            rc = lib.va_fused_step_f32(
                H.data_ptr(), x_old.data_ptr(), x_new.data_ptr(),
                g_old.data_ptr(), g_new.data_ptr(), head.data_ptr(),
                hlen.data_ptr(), flags.data_ptr(), B, m, n, d.data_ptr(),
                sc.data_ptr(), stream)
        _raise_on(rc, lib, "fused-step")
        STEP_LAUNCHES += 1
    return d, sc


def compact_dir(g, H, head, hlen):
    """The compact-form direction: the plain version for CPU tensors, K7a
    for CUDA tensors."""
    if H.device.type == "cpu":
        return compact_dir_reference(g, H, head, hlen)
    return compact_dir_kernel(g, H, head.to(torch.int32),
                              hlen.to(torch.int32))


def fused_step(H, x_old, x_new, g_old, g_new, head, hlen, ls_ok, run):
    """The fused step: the plain version for CPU tensors, K7b for CUDA
    tensors. See :func:`fused_step_reference`."""
    if H.device.type == "cpu":
        return fused_step_reference(H, x_old, x_new, g_old, g_new, head,
                                    hlen, ls_ok, run)
    return fused_step_kernel(H, x_old, x_new, g_old, g_new, head, hlen,
                             ls_ok, run)
