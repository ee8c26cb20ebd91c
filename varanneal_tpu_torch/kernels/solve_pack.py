"""K8: the packed-member whole rung solve, ``pack`` members a launch's
block (one a block at packs of 1 and 2, see :func:`block_groups`), each
solved by its own warp-aligned group of threads, over K2's envelope: the
four rules with a scalar or (N_f-1, D) rf, on Lorenz-96 and on the
row-level models (NaKL with or without its stimulus, Colpitts,
Lorenz-63), unbounded or bounded, at m <= 8.

Counterpart of ``varanneal_tpu/kernels/solve_pack_pallas.py``
(``pack_supported``, ``make_packed_rung_solver``), whose ``_pack_kernel``
this replaces on the card with the hand-written CUDA kernel of
``csrc/pack_kernels.cuh`` (``csrc/pack_kernel.cu`` notes what bounds it
and why its groups do not run in lockstep): Lorenz-96 under the
trapezoid rule with a scalar rf through ``csrc/pack_kernel.cu``, its
other rules and the (N_f-1, D) rf through ``csrc/pack_rules_<f32|f64>.cu``
and the row-level models through ``csrc/pack_models_<model>_<f32|f64>.cu``.
At packs of 1–2 a member has the whole block (G = 256), which is K2's
arrangement and bits: there the trapezoid rule with a scalar rf keeps
``pack_kernel.cu``'s own G = 256 kernel, and every other problem
launches its K2 entry (``solve.launch_k2``) on the padded batch,
counted as K8's, so that no third copy of K2 is built. The reference's
contract is the function: per member the iterates, niter, nfev and
status of the one-member kernel (K2, ``kernels/solve.py``), unbounded
or, with flat bounds, by the projection algorithm. Beside the kernel
this module holds:

- :func:`pack_reference`, the plain version: the batch padded to a
  multiple of the pack as the kernel's wrapper pads it, then
  ``solve.solve_reference`` (the batched loop with a per-member done
  mask, the reference's lockstep semantics, over ``ag.ag_reference``'s
  rules and models), the padding dropped;
- :data:`PACK_LAUNCHES`, a plain count of kernel launches, and, by rule
  and model, the keys "K8/..." of ``solve.RULE_LAUNCHES`` and
  ``solve.MODEL_LAUNCHES``;
- :func:`pack_supported` and :func:`pack_refusal` (the envelope),
  :func:`pack_group` (the group size a pack gets), :func:`pack_layout`
  (where a member's vectors live: K2's own plan at packs of 1–2; a
  group's area sized for its warps, ``ag.ring_cols``) and
  :func:`kernel_attrs` (the built kernel's registers, local memory and
  thread limit).

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
#: csrc/pack_kernels.cuh, the launch bound of every K8 block): 65,536
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
    256 (``block_groups`` in csrc/pack_kernels.cuh), else the pack's."""
    return 1 if pack_group(pack) == 256 else pack


def pack_layout(spec, dtype, pack: int, m: int, B: int, bounded=False,
                sm_count=132) -> solve.Layout:
    """Where a pack launch of ``B`` members (the padded batch) keeps each
    member's vectors, as a :class:`solve.Layout` (flags, a block's shared
    memory, a member's workspace); ``spec`` the problem (``ProblemSpec``)
    or the kernel's constants (``ag.AgConsts``). Packs of 1–2 (G = 256,
    one member a block) take K2's plan itself, :func:`solve.plan_layout`
    for ``B`` blocks on a card of ``sm_count`` SMs: vectors, history and
    box in shared memory where they fit, at up to one member an SM.
    Packs of 3–8 keep every vector in the global workspace (k members'
    vectors do not fit beside each other) and each group's area in shared
    memory: the solver's partials, which the evaluation's share, alpha and
    the evaluation's rings (a row-level model's area in their place),
    :func:`block_groups` times one member's of G / 32 warps, the rings
    ``ag.ring_cols(spec, G // 32)`` columns wide; the rings go to the
    workspaces (``solve.RING_OFF``) where they do not fit in 227 KB."""
    G = pack_group(pack)
    if G == 256:
        return solve.plan_layout(ag.ring_cols(spec), spec.n_dof, m, dtype,
                                 bounded, B, sm_count)
    warps, k = G // 32, block_groups(pack)
    cols = ag.ring_cols(spec, warps)
    flags = (0 if k * solve._smem_bytes(cols, dtype, warps)
             <= ag.SMEM_LIMIT else solve.RING_OFF)
    work = (5 + 2 * m) * spec.n_dof + 2 * m + (
        ag.ring_elems(cols, warps) if flags else 0)
    return solve.Layout(flags, k * solve._smem_bytes(cols, dtype, warps,
                                                     ring=not flags), work)


def _family(model: str, disc: str, diag: bool) -> str:
    """The library family of a problem: "l96" (Lorenz-96 under the
    trapezoid rule with a scalar rf, csrc/pack_kernel.cu), "l96_rule"
    (its other rules and the (N_f-1, D) rf, csrc/pack_rules_<f32|f64>.cu)
    or the row-level ``model``'s name
    (csrc/pack_models_<model>_<f32|f64>.cu); ``diag``: an (N_f-1, D) rf."""
    if model != "l96":
        return model
    return "l96_rule" if disc != "trapezoid" or diag else "l96"


def _entries(family: str, dtype=torch.float32):
    """(lib, launch, attrs) of ``family``'s library in ``dtype``, with
    their argument and result types set: the launch entry, and
    ``attrs(G, bounded, layout, out)``, the built kernel's attributes."""
    from varanneal_tpu_torch.kernels import _build
    t = solve._sfx(dtype)
    lib = _build.load("pack_kernel" if family == "l96" else
                      f"pack_rules_{t}" if family == "l96_rule" else
                      f"pack_models_{family}_{t}").lib
    P, I, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    if family == "l96":
        launch = getattr(lib, f"va_l96_pack_{t}")
        f64 = int(dtype == torch.float64)

        def attrs(G, bounded, layout, out):
            return lib.va_l96_pack_attrs(G, f64, bounded, layout, out)
    else:
        launch = getattr(lib, f"va_{family}_pack_{t}")
        attrs = getattr(lib, f"va_{family}_pack_attrs_{t}")
    if not getattr(launch, "_va_typed", False):
        l96 = [P, I, I, I, I, I, Dbl, P, P, P, P, I, I, I, Dbl, Dbl, Dbl]
        opts = [I, I, I, Dbl, Dbl, Dbl, Dbl]
        tail = [P, P, I, P, P, P, P, P, P]      # the box, work, outputs
        if family == "l96":
            launch.argtypes = l96 + opts + [I, I, I, Dbl] + tail
            lib.va_l96_pack_smem.restype = ctypes.c_longlong
            lib.va_l96_pack_smem.argtypes = [I, I, I, I, I, I, I]
            lib.va_l96_pack_attrs.argtypes = [I, I, I, I, P]
            lib.va_l96_pack_attrs.restype = I
        else:
            launch.argtypes = ((l96 + opts + [I, I, I, I, Dbl, P]
                                if family == "l96_rule" else
                                [P, I] + ag.ROW_ARGTYPES + opts
                                + [I, I, I, Dbl]) + tail)
            attrs.argtypes = [I, I, I, P]
            attrs.restype = I
        launch.restype = I
        lib.va_cuda_error_string.restype = ctypes.c_char_p
        lib.va_cuda_error_string.argtypes = [I]
        launch._va_typed = True
    return lib, launch, attrs


def kernel_attrs(G: int, dtype=torch.float32, bounded=False, layout=0,
                 family="l96") -> dict:
    """The built kernel's attributes for group size ``G`` under the
    layout's flags ``layout`` (building it at first use; needs the card):
    registers a thread, local memory a thread in bytes (spills and
    stack), and the most threads a block can launch with. ``family``:
    the problem's library (:func:`_family`); at G = 256 off "l96", the K2
    entry that a pack of 1–2 launches (``solve.kernel_attrs``; its chunk
    follows the layout, as at G = 256 on Lorenz-96's trapezoid rule)."""
    if G == 256 and family != "l96":
        a = solve.kernel_attrs(False, dtype, bounded, layout,
                               family == "l96_rule",
                               "l96" if family == "l96_rule" else family)
        return dict(regs=a["regs"], local_bytes=a["local_bytes"],
                    max_threads=a["max_threads"])
    lib, _, attrs = _entries(family, dtype)
    out = (ctypes.c_int * 3)()
    rc = attrs(int(G), int(bool(bounded)), int(layout), out)
    solve._raise_on(rc, lib, "cudaFuncGetAttributes of the packed-solve")
    return dict(regs=out[0], local_bytes=out[1], max_threads=out[2])


def pack_refusal(spec: ProblemSpec, rf, opts: LBFGSOptions,
                 dtype=torch.float32):
    """The first condition of :func:`pack_supported`'s problem and options
    that ``spec`` fails, in words, or None: K2's
    (``solve.solve_refusal``: the four rules, a scalar or (N_f-1, D) rf,
    Lorenz-96 and the three row-level models, less the log-space NaKL
    model, reference fault 7) and m <= :data:`MAX_M`, the reference's
    envelope (its ``pack_supported`` asks its K1's ``ag_supported``)."""
    if opts.m > MAX_M:
        return (f"m = {opts.m} (the packed solve takes m <= {MAX_M}, as "
                f"the reference's)")
    return solve.solve_refusal(spec, rf, opts, dtype)


def pack_supported(spec: ProblemSpec, rf, opts: LBFGSOptions, pack: int,
                   dtype=torch.float32, bounded=False, device=None) -> bool:
    """The packed kernel's envelope, with the reference's policy: pack >=
    1 with a group size (:func:`pack_group`) and K2's envelope at m <=
    :data:`MAX_M` (:func:`pack_refusal`). The TPU's VMEM model becomes
    the card's limit: a block's threads (:func:`block_groups` · G) within
    what the built kernel can launch (``cudaFuncGetAttributes``'
    maxThreadsPerBlock, read on the card; on the CPU, where the plain
    version runs, the kernel's launch bound). Shared memory bounds
    nothing: a member's vectors and the groups' rings go to the workspace
    where they do not fit (:func:`pack_layout`). False outside it; it does
    not raise. ``device=None`` means the card."""
    G = pack_group(pack)
    if G is None or pack_refusal(spec, rf, opts, dtype) is not None:
        return False
    if resolve_device(device).type != "cuda":
        return block_groups(pack) * G <= PACK_MAX_THREADS
    fam = _family(rowmodel.model_of(spec.f)[0], spec.disc,
                  np.ndim(rf) != 0)
    return (block_groups(pack) * G
            <= kernel_attrs(G, dtype, bounded, 0, fam)["max_threads"])


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
    block, at a scalar or (N_f-1, D) ``rf`` under ``c.disc``, inside the
    box ``lower``/``upper`` ((n_dof,) or (B, n_dof)) when given. Packs of
    1–2 off Lorenz-96's trapezoid rule with a scalar rf launch the
    problem's K2 entry on the padded batch (``solve.launch_k2``: K8 at G =
    256 is K2's arrangement and bits), counted here and not as K2's.
    Returns the B members' LBFGSResult on PyTorch's current stream,
    without synchronizing. Raises on anything the kernel does not take
    and on a refused launch."""
    global PACK_LAUNCHES
    solve._check_input(XP, c, opts)
    if opts.m > MAX_M:
        raise ValueError(f"the packed-solve kernel takes m <= {MAX_M}; got "
                         f"{opts.m}")
    G = pack_group(pack)
    if G is None:
        raise ValueError(f"pack must be 1..{PACK_MAX_THREADS // GROUPS[-1]}"
                         f"; got {pack}")
    rf_s, rfd = ag._rf_arg(rf, c)
    fam = _family(c.model, c.disc, rfd is not None)
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
        outs = (X.data_ptr(), Gr.data_ptr(), fp.data_ptr(), cnt.data_ptr())
        if G == 256 and fam != "l96":
            solve.launch_k2(XPp, rf_s, rfd, c, opts, lay, bnd, X, Gr, fp,
                            cnt)
        else:
            work = torch.empty(Bp, max(lay.work_elems, 1), dtype=XP.dtype,
                               device=XP.device)
            lib, fn, _ = _entries(fam, c.dtype)
            rf_args = ((ag.DISCS[c.disc], rf_s,
                        None if rfd is None else rfd.data_ptr())
                       if fam == "l96_rule" else (rf_s,))
            with torch.cuda.device(XP.device):
                stream = torch.cuda.current_stream(XP.device).cuda_stream
                rc = fn(*solve._common_args(XPp, c, opts, rfd), int(pack),
                        G, lay.flags, *rf_args, *bnd, work.data_ptr(),
                        *outs, stream)
            solve._raise_on(rc, lib, "packed-solve")
        PACK_LAUNCHES += 1
        solve._count_key("K8", c, rfd)
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
    call runs a pack of one. ``rf``: a scalar or the rung's (N_f-1, D)
    rf, as ``solve.make_rung_solver`` takes it. ``lower``/``upper``: flat
    (n_dof,) bounds (``api.build_bounds``; a missing side and ±inf
    entries free), under which the kernel runs the projection algorithm.
    ``device=None`` means the CUDA card. Raises outside the packed
    kernel's envelope (:func:`pack_refusal` in some dtype) or for a pack
    without a group size."""
    solve._check_envelope(spec, 0.0, opts)
    if opts.m > MAX_M:
        raise ValueError(f"problem outside the packed-solve kernel's "
                         f"envelope: {pack_refusal(spec, 0.0, opts)}")
    if pack_group(pack) is None:
        raise ValueError(f"pack must be 1..{PACK_MAX_THREADS // GROUPS[-1]}"
                         f"; got {pack}")
    consts = solve._Consts(spec, resolve_device(device))
    bounds = solve.flat_bounds(spec, lower, upper, consts.device)

    def run(XP, rf):
        one = XP.ndim == 1
        XP2 = XP[None] if one else XP
        c = consts(XP.dtype)
        lo, hi = bounds(XP)
        rf = float(rf) if np.ndim(rf) == 0 else rf
        k = 1 if one else int(pack)
        if XP.device.type == "cpu":
            if XP.device != c.device:
                raise ValueError(f"XP is on {XP.device}; the solver is on "
                                 f"{c.device}")
            res = pack_reference(XP2, rf, c, opts, k, lo, hi)
        else:
            res = pack_kernel(XP2, rf, c, opts, k, lo, hi)
        return LBFGSResult(*(v[0] for v in res)) if one else res

    return run
