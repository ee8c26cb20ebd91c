"""K8: the packed-member whole rung solve, ``pack`` members a launch's
block (one a block at packs of 1 and 2, see :func:`block_groups`), each
solved by its own warp-aligned group of threads.

Counterpart of ``varanneal_tpu/kernels/solve_pack_pallas.py``
(``pack_supported``, ``make_packed_rung_solver``), whose ``_pack_kernel``
this replaces on the card with the hand-written CUDA kernel in
``csrc/pack_kernel.cu`` (the source notes what bounds it and why its
groups do not run in lockstep). The reference's contract is the
function: per member the iterates, niter, nfev and status of the
one-member kernel (K2, ``kernels/solve.py``), unbounded or, with flat
bounds, by the projection algorithm. Beside the kernel this module holds:

- :func:`pack_reference`, the plain version: the batch padded to a
  multiple of the pack as the kernel's wrapper pads it, then
  ``solve.solve_reference`` (the batched loop with a per-member done
  mask, the reference's lockstep semantics), the padding dropped;
- :data:`PACK_LAUNCHES`, a plain count of kernel launches;
- :func:`pack_supported` (the envelope), :func:`pack_group` (the group
  size a pack gets), :func:`pack_layout` (where a member's vectors live:
  K2's own plan at packs of 1–2) and :func:`kernel_attrs` (the built
  kernel's registers, local memory and thread limit).

The reference's compile probe (``_compile_pack``/``_probe_ok``) has no
counterpart: the envelope is analytic, the card's limits read from the
built kernel. A solver takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

import ctypes

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.kernels import ag, rowmodel, solve
from varanneal_tpu_torch.opt.lbfgs import LBFGSOptions, LBFGSResult
from varanneal_tpu_torch.ops.spec import ProblemSpec

#: Launches of the packed solve kernel (K8) so far.
PACK_LAUNCHES = 0

#: Threads a block of packed groups may have (kPackMaxThreads in
#: csrc/pack_kernel.cu, the launch bound of every K8 block): 65,536
#: registers / 255 leave room for 256 threads, so each thread keeps up to
#: 255 registers, as K2's and K3's do. At 512 threads (the first port's
#: bound) a thread had 128 and the solver's walk spilled.
PACK_MAX_THREADS = 256
#: Group sizes the kernel is built for, largest first: 256 (one member a
#: block, K2's arrangement), 64 and 32 (one warp).
GROUPS = (256, 64, 32)
#: The reference's cap on the history of a packed solve.
MAX_M = 8


def pack_group(pack: int):
    """Threads a member gets in a pack of ``pack``: 256 for packs of 1–2
    (one member a block, K2's arrangement and bits), else the largest of
    :data:`GROUPS` with pack · G <= :data:`PACK_MAX_THREADS` (64 for packs
    of 3–4, 32 for 5–8), so that a block of the pack's groups keeps 255
    registers a thread; None beyond."""
    if pack in (1, 2):
        return GROUPS[0]
    for G in GROUPS[1:]:
        if pack >= 1 and pack * G <= PACK_MAX_THREADS:
            return G
    return None


def block_groups(pack: int) -> int:
    """Groups (members) a block holds for a pack of ``pack``: one at G =
    256 (``block_groups`` in csrc/pack_kernel.cu), else the pack's."""
    return 1 if pack_group(pack) == 256 else pack


def pack_layout(spec: ProblemSpec, dtype, pack: int, m: int, B: int,
                bounded=False, sm_count=132) -> solve.Layout:
    """Where a pack launch of ``B`` members (the padded batch) keeps each
    member's vectors, as a :class:`solve.Layout` (flags, a block's shared
    memory, a member's workspace). Packs of 1–2 (G = 256, one member a
    block) take K2's plan itself, :func:`solve.plan_layout` for ``B``
    blocks on a card of ``sm_count`` SMs: vectors, history and box in
    shared memory where they fit, at up to one member an SM. Packs of 3–8
    keep every vector in the global workspace (k members' vectors do not
    fit beside each other) and each group's area in shared memory: the
    solver's partials, which the evaluation's share, alpha and its rings,
    :func:`block_groups` times one member's of G / 32 warps; the rings go
    to the workspaces (``solve.RING_OFF``) where they do not fit in 227
    KB."""
    G = pack_group(pack)
    if G == 256:
        return solve.plan_layout(spec.D, spec.n_dof, m, dtype, bounded, B,
                                 sm_count)
    warps, k = G // 32, block_groups(pack)
    flags = (0 if k * solve._smem_bytes(spec.D, dtype, warps)
             <= ag.SMEM_LIMIT else solve.RING_OFF)
    work = (5 + 2 * m) * spec.n_dof + 2 * m + (
        ag.ring_elems(spec.D, warps) if flags else 0)
    return solve.Layout(flags, k * solve._smem_bytes(spec.D, dtype, warps,
                                                     ring=not flags), work)


def _lib():
    from varanneal_tpu_torch.kernels import _build
    lib = _build.load("pack_kernel").lib
    if not getattr(lib, "_va_typed", False):
        P, I, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        common = [P, I, I, I, I, I, Dbl, P, P, P, P, I, I, I, Dbl, Dbl, Dbl,
                  I, I, I, Dbl, Dbl, Dbl, Dbl]
        for fn in (lib.va_l96_pack_f32, lib.va_l96_pack_f64):
            fn.restype = I
            fn.argtypes = common + [I, I, I, Dbl, P, P, I, P, P, P, P, P,
                                    P]
        lib.va_l96_pack_smem.restype = ctypes.c_longlong
        lib.va_l96_pack_smem.argtypes = [I, I, I, I, I, I, I]
        lib.va_l96_pack_attrs.restype = I
        lib.va_l96_pack_attrs.argtypes = [I, I, I, I, P]
        lib.va_cuda_error_string.restype = ctypes.c_char_p
        lib.va_cuda_error_string.argtypes = [I]
        lib._va_typed = True
    return lib


def kernel_attrs(G: int, dtype=torch.float32, bounded=False,
                 layout=0) -> dict:
    """The built kernel's attributes for group size ``G`` under the
    layout's flags ``layout`` (at G = 256 the chunk follows the layout, as
    K2's does) (building it at first use; needs the card): registers a
    thread, local memory a thread in bytes (spills and stack), and the
    most threads a block can launch with."""
    lib = _lib()
    out = (ctypes.c_int * 3)()
    rc = lib.va_l96_pack_attrs(int(G), int(dtype == torch.float64),
                               int(bool(bounded)), int(layout), out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes of the packed-solve "
                           f"kernel failed: cudaError {rc} "
                           f"({lib.va_cuda_error_string(rc).decode()})")
    return dict(regs=out[0], local_bytes=out[1], max_threads=out[2])


def pack_refusal(spec: ProblemSpec, rf):
    """The model, rule or rf kind K8 does not take, in words, or None: K8
    takes Lorenz-96 under the trapezoid rule with a scalar rf, where K1/K2
    take the row-level models, four rules and an (N_f-1, D) rf too."""
    model = rowmodel.model_of(spec.f)
    if model is not None and model[0] != "l96":
        return (f"the {model[0]} model (K8 takes Lorenz-96; the row-level "
                f"models wait for ROADMAP.md §2a item 2 (e))")
    if spec.disc != "trapezoid" or np.ndim(rf) != 0:
        kind = "a scalar" if np.ndim(rf) == 0 else f"a {np.shape(rf)}"
        return (f"disc {spec.disc!r} with {kind} rf (K8 takes the "
                f"trapezoid rule with a scalar rf; the other rules and the "
                f"(N_f-1, D) rf wait for ROADMAP.md §2a item 2 (e))")
    return None


def pack_supported(spec: ProblemSpec, rf, opts: LBFGSOptions, pack: int,
                   dtype=torch.float32, bounded=False, device=None) -> bool:
    """The packed kernel's envelope, with the reference's policy: pack >=
    1, m <= :data:`MAX_M` (and maxls >= 1), the trapezoid rule with a
    scalar rf (:func:`pack_refusal`) and K1's envelope
    (:func:`ag.ag_supported`). The TPU's VMEM model becomes the card's
    limit: a block's threads (:func:`block_groups` · G) within what the
    built kernel can launch (``cudaFuncGetAttributes``'
    maxThreadsPerBlock, read on the card; on the CPU, where the plain
    version runs, the kernel's launch bound).
    Shared memory bounds nothing: a member's vectors and the groups'
    rings go to the workspace where they do not fit (:func:`pack_layout`). False outside it; it does
    not raise. ``device=None`` means the card."""
    G = pack_group(pack)
    if (G is None or not 1 <= opts.m <= MAX_M or opts.maxls < 1
            or pack_refusal(spec, rf) is not None
            or not ag.ag_supported(spec, 0.0, dtype)):
        return False
    if resolve_device(device).type != "cuda":
        return block_groups(pack) * G <= PACK_MAX_THREADS
    return (block_groups(pack) * G
            <= kernel_attrs(G, dtype, bounded)["max_threads"])


def _pad(t, pad):
    """``t`` (B, ...) with its last row repeated ``pad`` more times."""
    if not pad:
        return t
    return torch.cat([t, t[-1:].expand((pad,) + tuple(t.shape[1:]))])


def _cut(res: LBFGSResult, B: int) -> LBFGSResult:
    return LBFGSResult(*(v[:B] for v in res))


def pack_reference(XP, rf, c: ag.AgConsts, opts: LBFGSOptions, pack: int,
                   lower=None, upper=None):
    """Plain PyTorch packed solve: ``XP`` (B, n_dof) padded to a multiple
    of ``pack`` by repeating the last member, :func:`solve.solve_reference`
    over the padded batch (each member frozen once its loop ends), the
    padding's outputs dropped. Bounds: (n_dof,) or (B, n_dof)."""
    B = XP.shape[0]
    pad = (-B) % pack
    lo, hi = solve._check_bounds(lower, upper, XP)
    if lo is not None and lo.ndim == 2:
        lo, hi = _pad(lo, pad), _pad(hi, pad)
    return _cut(solve.solve_reference(_pad(XP, pad), rf, c, opts, lo, hi),
                B)


def pack_kernel(XP, rf, c: ag.AgConsts, opts: LBFGSOptions, pack: int,
                lower=None, upper=None):
    """Launch K8 on ``XP`` (B, n_dof), a CUDA tensor of ``c``'s dtype on
    ``c``'s device: the batch padded to a multiple of ``pack``, one group
    of :func:`pack_group` threads a member, :func:`block_groups` groups a
    block, at scalar
    ``rf``, inside the box ``lower``/``upper`` ((n_dof,) or (B, n_dof))
    when given. Returns the B members' LBFGSResult on PyTorch's current
    stream, without synchronizing. Raises on anything the kernel does not
    take and on a refused launch."""
    global PACK_LAUNCHES
    solve._check_input(XP, c, opts)
    if c.disc != "trapezoid" or np.ndim(rf) != 0:
        raise ValueError("the packed-solve kernel takes the trapezoid rule "
                         "with a scalar rf (ROADMAP.md §2a item 2 (e))")
    G = pack_group(pack)
    if G is None:
        raise ValueError(f"pack must be 1..{PACK_MAX_THREADS // GROUPS[-1]}"
                         f"; got {pack}")
    B = XP.shape[0]
    pad = (-B) % pack
    lo, hi = solve._check_bounds(lower, upper, XP)
    bnd = (None, None, 0)
    if lo is not None:
        if lo.ndim == 2:
            lo, hi = _pad(lo, pad).contiguous(), _pad(hi, pad).contiguous()
        bnd = (lo.data_ptr(), hi.data_ptr(),
               XP.shape[1] if lo.ndim == 2 else 0)
    XPp = _pad(XP, pad).contiguous()
    Bp = XPp.shape[0]
    X = torch.empty_like(XPp)
    Gr = torch.empty_like(XPp)
    fp = torch.empty(Bp, 2, dtype=XP.dtype, device=XP.device)
    cnt = torch.empty(Bp, 3, dtype=torch.int32, device=XP.device)
    if Bp:
        sms = torch.cuda.get_device_properties(
            XP.device).multi_processor_count
        lay = pack_layout(c, XP.dtype, pack, opts.m, Bp, lo is not None,
                          sms)
        work = torch.empty(Bp, max(lay.work_elems, 1), dtype=XP.dtype,
                           device=XP.device)
        lib = _lib()
        fn = (lib.va_l96_pack_f32 if c.dtype == torch.float32
              else lib.va_l96_pack_f64)
        with torch.cuda.device(XP.device):
            stream = torch.cuda.current_stream(XP.device).cuda_stream
            rc = fn(*solve._common_args(XPp, c, opts), int(pack), G,
                    lay.flags,
                    float(rf), *bnd, work.data_ptr(), X.data_ptr(),
                    Gr.data_ptr(), fp.data_ptr(), cnt.data_ptr(), stream)
        solve._raise_on(rc, lib, "packed-solve")
        PACK_LAUNCHES += 1
    return _cut(LBFGSResult(x=X, f=fp[:, 0], g=Gr, niter=cnt[:, 0],
                            nfev=cnt[:, 1], status=cnt[:, 2],
                            pgnorm=fp[:, 1]), B)


def make_packed_rung_solver(spec: ProblemSpec, opts: LBFGSOptions,
                            pack: int, lower=None, upper=None, device=None):
    """Build ``solve(XP, rf) -> LBFGSResult`` running ``pack`` members a
    block (:func:`pack_kernel`), a drop-in for ``anneal.run_ladder``'s
    ``rung_solver=`` hook with the reference's semantics: a batch (B,
    n_dof) not a multiple of ``pack`` is padded by repeating its last
    member and the padding's outputs are dropped; an unbatched (n_dof,)
    call runs a pack of one. ``lower``/``upper``: flat (n_dof,) bounds
    (``api.build_bounds``; a missing side and ±inf entries free), under
    which the kernel runs the projection algorithm. ``device=None`` means
    the CUDA card. Raises outside the solve kernels' envelope or for a
    pack without a group size."""
    solve._check_envelope(spec, 0.0, opts)
    why = pack_refusal(spec, 0.0)
    if why is not None:
        raise ValueError(f"problem outside the packed-solve kernel's "
                         f"envelope: {why}")
    if pack_group(pack) is None:
        raise ValueError(f"pack must be 1..{PACK_MAX_THREADS // GROUPS[-1]}"
                         f"; got {pack}")
    consts = solve._Consts(spec, resolve_device(device))
    bounds = solve.flat_bounds(spec, lower, upper, consts.device)

    def run(XP, rf):
        if np.ndim(rf) != 0:
            raise ValueError("the packed-solve kernel takes a scalar rf "
                             "only")
        one = XP.ndim == 1
        XP2 = XP[None] if one else XP
        c = consts(XP.dtype)
        lo, hi = bounds(XP)
        k = 1 if one else int(pack)
        if XP.device.type == "cpu":
            if XP.device != c.device:
                raise ValueError(f"XP is on {XP.device}; the solver is on "
                                 f"{c.device}")
            res = pack_reference(XP2, float(rf), c, opts, k, lo, hi)
        else:
            res = pack_kernel(XP2, float(rf), c, opts, k, lo, hi)
        return LBFGSResult(*(v[0] for v in res)) if one else res

    return run
