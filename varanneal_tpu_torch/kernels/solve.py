"""K2 and K3: the whole L-BFGS rung solve (unbounded, or bounded by the
projection algorithm), and a whole warm-started ladder of unbounded
rungs, each in one launch, under the four rules, on Lorenz-96 and on the
built-in row-level models (NaKL with or without its stimulus, Colpitts,
Lorenz-63).

Counterpart of ``varanneal_tpu/kernels/solve_pallas.py``
(``solve_supported``, ``ladder_supported``, ``solve_preferred``,
``pick_rung_solver``, ``make_rung_solver``, ``make_ladder_solver``),
whose ``_solve_kernel`` and ``_ladder_kernel`` this replaces on the card
with the hand-written CUDA kernels in ``csrc/solve_kernel.cu`` (the
trapezoid rule with a scalar rf) and ``csrc/solve_rules_f32.cu`` /
``solve_rules_f64.cu`` (the other rules, and K2's (N_f-1, D) rf; their
notes are ``csrc/l96_solve_rules.cuh``'s: what bounds them and what
their design does about it), and on the row-level models with
``csrc/solve_models_<model>_<f32|f64>.cu`` (every rule and rf kind;
notes in ``csrc/row_solve.cuh``: the same kernels, each evaluation K1's
walk by thread). K2 takes a scalar or (N_f-1, D) rf, K3 a scalar rf, as
the reference's. Beside the kernels this module holds:

- :func:`solve_reference` and :func:`ladder_reference`, the plain
  versions: the port's batched ``opt/lbfgs.lbfgs_minimize`` with
  ``direction='two_loop'`` (with bounds, its projection algorithm) over
  K1's plain ``ag_reference``, and its loop over rungs with the same
  records;
- :data:`RUNG_LAUNCHES` and :data:`LADDER_LAUNCHES`, plain counts of
  kernel launches, :data:`RULE_LAUNCHES`, the Lorenz-96 rules' entries'
  launches by kernel, rule and rf kind, and :data:`MODEL_LAUNCHES`, the
  row-level models' by kernel, model, rule and rf kind;
- :func:`solve_supported` and :func:`ladder_supported`, the envelope,
  and :func:`solve_preferred` and :func:`pick_rung_solver`, the policy
  of the facade's ``solver=``;
- :func:`plan_layout`, which puts a member's vectors in shared memory
  where they fit (the kernels' layout argument), and
  :func:`kernel_attrs`, the built kernels' registers and local memory.

A solver takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches its kernel or raises; it never falls back.

The kernels follow ``_solve_one`` where it and ``opt/lbfgs.py`` differ in
detail; the plain version keeps ``opt/lbfgs.py``'s forms, which differ
from the kernel's only in rounding: denominators clamped at 1e-300
rather than 1e-30 (only a curvature below 1e-30 would tell them apart,
and the curvature gate refuses such pairs), the gate's
``sqrt(ss)·sqrt(yy)`` against ``sqrt(s2·y2)``, the projected-gradient
norm ``max|x - clamp(x - g)|`` against ``max|g|`` (equal up to the last
bit of x), and the initial clamp of x to the dtype's range (a no-op on
finite inputs).
"""

import ctypes
import dataclasses
import warnings

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.kernels import ag
from varanneal_tpu_torch.opt.lbfgs import (LBFGSOptions, LBFGSResult,
                                           lbfgs_minimize)
from varanneal_tpu_torch.ops.spec import ProblemSpec

#: Launches of the rung-solve kernel (K2) so far.
RUNG_LAUNCHES = 0
#: Launches of the ladder kernel (K3) so far.
LADDER_LAUNCHES = 0
#: Launches under Lorenz-96's other rules and the (N_f-1, D) rf so far
#: (csrc/solve_rules_*.cu; K8's csrc/pack_rules_*.cu), by
#: "K2/<disc>/<rf kind>", "K3/<disc>/scalar" and "K8/<disc>/<rf kind>";
#: each also counts in RUNG_LAUNCHES, LADDER_LAUNCHES or
#: solve_pack.PACK_LAUNCHES.
RULE_LAUNCHES = {}
#: Launches on the row-level models so far (csrc/solve_models_*.cu; K8's
#: csrc/pack_models_*.cu), by "K2/<model>/<disc>/<rf kind>",
#: "K3/<model>/<disc>/scalar" and "K8/<model>/<disc>/<rf kind>"; each
#: also counts in RUNG_LAUNCHES, LADDER_LAUNCHES or
#: solve_pack.PACK_LAUNCHES.
MODEL_LAUNCHES = {}

#: Largest history the kernels take (kMaxM in csrc/l96_solve.cuh).
MAX_M = 16
#: Most values one reduction of the solver carries (kMaxRed).
MAX_RED = 6

#: The layout's flags (kVectorsOnChip, kHistoryOnChip, kBoundsOnChip in
#: csrc/l96_solve.cuh): the groups of a member's vectors in shared memory;
#: and RING_OFF (kRingOffChip), the evaluation's rings in the workspace.
VECTORS, HISTORY, BOUNDS, RING_OFF = 1, 2, 4, 8


def _smem_bytes(D, dtype, warps=ag._WARPS, ring=True):
    """solve_smem_elems in bytes, one group of ``warps`` warps (the whole
    block by default): two areas of :data:`MAX_RED` partials a warp,
    which the evaluation's partials share, :data:`MAX_M` alphas and, with
    ``ring``, the evaluation's rings (``ag.ring_elems``). It does not grow
    with N."""
    return (2 * MAX_RED * warps + MAX_M
            + (ag.ring_elems(D, warps) if ring else 0)) * (
                torch.finfo(dtype).bits // 8)


def _groups(n_dof, m, bounded):
    """The groups of a member's vectors in the planner's order, with their
    sizes in elements: x, g, d and the trial x and g; the history S, Y and
    its per-pair s·y, y·y; the box."""
    return ((VECTORS, 5 * n_dof), (HISTORY, 2 * m * n_dof + 2 * m)) + (
        ((BOUNDS, 2 * n_dof),) if bounded else ())


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a launch keeps each member's vectors: ``flags``, the groups
    in shared memory (and RING_OFF); ``smem_bytes``, the block's dynamic
    shared memory; ``work_elems``, a member's global workspace in
    elements (the groups off chip, then the rings under RING_OFF; the box
    stays in the caller's arrays)."""
    flags: int
    smem_bytes: int
    work_elems: int


def layout_of(flags, D, n_dof, m, dtype, bounded) -> Layout:
    """The :class:`Layout` with the groups of ``flags`` on chip."""
    size = torch.finfo(dtype).bits // 8
    ring_off = bool(flags & RING_OFF)
    smem = _smem_bytes(D, dtype, ring=not ring_off)
    work = ag.ring_elems(D) if ring_off else 0
    for flag, elems in _groups(n_dof, m, bounded):
        if flags & flag:
            smem += elems * size
        elif flag != BOUNDS:
            work += elems
    return Layout(flags, smem, work)


def plan_layout(D, n_dof, m, dtype, bounded, B, sm_count) -> Layout:
    """The layout of a K2/K3 launch of ``B`` members on a card of
    ``sm_count`` SMs. The evaluation's rings stay on chip where they fit
    in the block's 227 KB (:data:`ag.SMEM_LIMIT`; D up to 1,208 in
    float32 and 603 in float64), else RING_OFF. Then, with at most one
    member an SM, each group of :func:`_groups` in turn goes to shared
    memory if it fits whole in what the ones before it left. Above that
    the global layout: the rule was set when that layout ran two blocks
    an SM where a block of ~200 KB runs one, and was then 1.1–1.3x faster
    at B = 133–200 and 7–8 % slower at B = 264 and 528. With the
    evaluation's walk every layout takes one block's registers, and at
    B = 264 the on-chip layout was the faster (PERF.md §6); ROADMAP.md §2
    queues the rule's revision."""
    size = torch.finfo(dtype).bits // 8
    flags = 0 if _smem_bytes(D, dtype) <= ag.SMEM_LIMIT else RING_OFF
    smem = _smem_bytes(D, dtype, ring=not flags)
    if B <= sm_count:
        for flag, elems in _groups(n_dof, m, bounded):
            if smem + elems * size <= ag.SMEM_LIMIT:
                flags |= flag
                smem += elems * size
    return layout_of(flags, D, n_dof, m, dtype, bounded)


def solve_refusal(spec: ProblemSpec, rf, opts: LBFGSOptions,
                  dtype=torch.float32):
    """The first condition of :func:`solve_supported` that fails, in
    words, or None inside the envelope."""
    if not 1 <= opts.m <= MAX_M:
        return f"m = {opts.m} (the solve kernels take 1 <= m <= {MAX_M})"
    if opts.maxls < 1:
        return f"maxls = {opts.maxls} (at least 1)"
    return ag.ag_refusal(spec, rf, dtype)


def solve_supported(spec: ProblemSpec, rf, opts: LBFGSOptions,
                    dtype=torch.float32) -> bool:
    """The rung-solve kernel's envelope, bounded or not: K1's
    (:func:`ag.ag_supported`: the four rules, a scalar or (N_f-1, D) rf),
    1 <= m <= :data:`MAX_M` and maxls >= 1. Shared memory bounds
    nothing: the group's own area is 112 values plus the evaluation's
    rings, which go to the workspace where they do not fit, and the
    vectors, the history and the bounds go to shared memory only where
    they fit (:func:`plan_layout`). :func:`solve_refusal` names the
    condition a problem fails."""
    return solve_refusal(spec, rf, opts, dtype) is None


def ladder_supported(spec: ProblemSpec, rf, opts: LBFGSOptions,
                     dtype=torch.float32, n_rungs: int = 1) -> bool:
    """The ladder kernel's envelope: the rung solve's at a scalar rf (the
    reference's ``ladder_supported``), for n_rungs >= 1. One launch runs
    every rung; a caller that wants shorter launches builds a solver for
    fewer rungs and chains the calls."""
    return (n_rungs >= 1 and np.ndim(rf) == 0
            and solve_supported(spec, rf, opts, dtype=dtype))


def solve_reference(XP, rf, c: ag.AgConsts, opts: LBFGSOptions,
                    lower=None, upper=None):
    """Plain PyTorch rung solve: the batched two-loop L-BFGS over K1's
    plain action and gradient, with bounds its projection algorithm.
    ``XP`` (B, n_dof) -> LBFGSResult."""
    return lbfgs_minimize(lambda z: ag.ag_reference(z, rf, c), XP,
                          lower=lower, upper=upper,
                          opts=dataclasses.replace(
                              opts, direction="two_loop",
                              bounded_algo="projection"),
                          device=XP.device)


_RECORDS = ("A", "ME", "FE", "pgnorm", "niter", "nfev", "status")


def ladder_reference(XP, rfs, c: ag.AgConsts, opts: LBFGSOptions):
    """Plain PyTorch ladder: :func:`solve_reference` over the rung values
    ``rfs``, warm-started. Returns (XP_out, records) as the kernel does."""
    recs = {k: [] for k in _RECORDS}
    for rf in rfs:
        res = solve_reference(XP, float(rf), c, opts)
        XP = res.x
        _, me = ag.measurement_error(
            XP[:, : c.n_state].reshape(-1, c.N, c.D), c)
        for k, v in (("A", res.f), ("ME", me), ("FE", res.f - me),
                     ("pgnorm", res.pgnorm), ("niter", res.niter),
                     ("nfev", res.nfev), ("status", res.status)):
            recs[k].append(v)
    return XP, {k: torch.stack(v, dim=1) for k, v in recs.items()}


def typed(lib):
    """``lib`` (a ctypes library built from csrc/solve_kernel.cu,
    csrc/solve_rules_f32.cu / solve_rules_f64.cu or a
    csrc/solve_models_*.cu) with its functions' argument and result types
    set."""
    if not getattr(lib, "_va_typed", False):
        P, I, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        common = [P, I, I, I, I, I, Dbl, P, P, P, P, I, I, I, Dbl, Dbl, Dbl,
                  I, I, I, Dbl, Dbl, Dbl, Dbl]
        opts = [I, I, I, Dbl, Dbl, Dbl, Dbl]
        models = [(m, t) for m in ag.ROW_MODELS for t in ("f32", "f64")
                  if hasattr(lib, f"va_{m}_solve_{t}")]
        if models:
            m, t = models[0]
            row = [P, I] + ag.ROW_ARGTYPES + opts + [I]
            fn = getattr(lib, f"va_{m}_solve_{t}")
            fn.restype = I
            fn.argtypes = row + [Dbl, P, P, I, P, P, P, P, P, P]
            fn = getattr(lib, f"va_{m}_ladder_{t}")
            fn.restype = I
            fn.argtypes = row + [P, I, P, P, P, P, P]
            fn = getattr(lib, f"va_{m}_solve_attrs_{t}")
            fn.restype = I
            fn.argtypes = [I, I, I, P]
        elif hasattr(lib, "va_l96_solve_rule_attrs"):
            sfx = "f32" if hasattr(lib, "va_l96_solve_rule_f32") else "f64"
            fn = getattr(lib, f"va_l96_solve_rule_{sfx}")
            fn.restype = I
            fn.argtypes = common + [I, I, Dbl, P, P, P, I, P, P, P, P, P, P]
            fn = getattr(lib, f"va_l96_ladder_rule_{sfx}")
            fn.restype = I
            fn.argtypes = common + [I, I, P, I, P, P, P, P, P]
            lib.va_l96_solve_rule_attrs.restype = I
            lib.va_l96_solve_rule_attrs.argtypes = [I, I, I, P]
        else:
            for fn in (lib.va_l96_solve_f32, lib.va_l96_solve_f64):
                fn.restype = I
                fn.argtypes = common + [I, Dbl, P, P, I, P, P, P, P, P, P]
            for fn in (lib.va_l96_ladder_f32, lib.va_l96_ladder_f64):
                fn.restype = I
                fn.argtypes = common + [I, P, I, P, P, P, P, P]
            lib.va_l96_solve_smem.restype = ctypes.c_longlong
            lib.va_l96_solve_smem.argtypes = [I, I, I, I, I]
            lib.va_l96_solve_attrs.restype = I
            lib.va_l96_solve_attrs.argtypes = [I, I, I, I, P]
        lib.va_cuda_error_string.restype = ctypes.c_char_p
        lib.va_cuda_error_string.argtypes = [I]
        lib._va_typed = True
    return lib


def _sfx(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def _lib(rules=False, dtype=torch.float32, model="l96"):
    """The library of csrc/solve_kernel.cu, or with ``rules`` that of
    ``dtype``'s rules' entries (csrc/solve_rules_f32.cu or
    solve_rules_f64.cu), or that of a row-level ``model`` in ``dtype``
    (csrc/solve_models_<model>_<f32|f64>.cu)."""
    from varanneal_tpu_torch.kernels import _build
    if model != "l96":
        name = f"solve_models_{model}_{_sfx(dtype)}"
    else:
        name = "solve_rules_" + _sfx(dtype) if rules else "solve_kernel"
    return typed(_build.load(name).lib)


def _is_rule(c: ag.AgConsts, rfd) -> bool:
    """Whether a launch goes to the rules' entries: a rule other than the
    trapezoid rule, or an (N_f-1, D) rf."""
    return c.disc != "trapezoid" or rfd is not None


def kernel_attrs(ladder: bool, dtype=torch.float32, bounded=False,
                 layout=0, rules=False, model="l96") -> dict:
    """The attributes of the built kernel, K3 (``ladder``) or K2 (of the
    rules' entries with ``rules``, of a row-level ``model``'s), that a
    launch under the layout's flags ``layout`` runs (building it at first
    use; needs the card): registers a thread, local memory a thread in
    bytes (spills and stack), the most threads a block can launch with,
    and the threads a launch takes."""
    lib = _lib(rules, dtype, model)
    out = (ctypes.c_int * 4)()
    if model != "l96":
        rc = getattr(lib, f"va_{model}_solve_attrs_{_sfx(dtype)}")(
            int(bool(ladder)), int(bool(bounded)), int(layout), out)
    elif rules:
        rc = lib.va_l96_solve_rule_attrs(int(bool(ladder)),
                                         int(bool(bounded)), int(layout),
                                         out)
    else:
        rc = lib.va_l96_solve_attrs(int(bool(ladder)),
                                    int(dtype == torch.float64),
                                    int(bool(bounded)), int(layout), out)
    _raise_on(rc, lib, "cudaFuncGetAttributes of the solve")
    return dict(regs=out[0], local_bytes=out[1], max_threads=out[2],
                threads=out[3])


def _check_input(XP, c: ag.AgConsts, opts: LBFGSOptions):
    if not 1 <= opts.m <= MAX_M or opts.maxls < 1:
        raise ValueError(f"the solve kernels take 1 <= m <= {MAX_M} and "
                         f"maxls >= 1; got m={opts.m}, maxls={opts.maxls}")
    if XP.device.type != "cuda" or XP.device != c.device:
        raise ValueError(f"XP is on {XP.device}; the kernel's constants "
                         f"are on {c.device}")
    if XP.dtype != c.dtype or XP.ndim != 2 or XP.shape[1] != c.n_dof:
        raise ValueError(f"XP must be (B, {c.n_dof}) {c.dtype}; got "
                         f"{tuple(XP.shape)} {XP.dtype}")


def _common_args(XP, c: ag.AgConsts, opts: LBFGSOptions, rfd=None):
    """The entries' leading arguments: Lorenz-96's problem (VA_SOLVE_ARGS)
    or a row-level model's (VA_ROW_ARGS, its (N_f-1, D) rf ``rfd`` among
    them), then the options."""
    o = (opts.m, opts.maxiter, opts.maxls, opts.c1, opts.c2, opts.pgtol,
         opts.ftol)
    if c.model != "l96":
        return (XP.data_ptr(), XP.shape[0], *ag.row_args(c, rfd), *o)
    return (XP.data_ptr(), XP.shape[0], c.n_dof, c.N, c.D, c.pslot,
            c.F_fixed, c.Y.data_ptr(), c.W.data_ptr(), c.lidx.data_ptr(),
            c.lpos.data_ptr(), c.N_data, c.L, c.obs_stride, c.h,
            c.me_norm, c.fe_norm, *o)


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {rc} "
            f"({lib.va_cuda_error_string(rc).decode()})")


def _workspace(XP, layout: Layout):
    """Each member's global workspace: what ``layout`` leaves off chip
    (at least one element, so that the pointer is valid)."""
    return torch.empty(XP.shape[0], max(layout.work_elems, 1),
                       dtype=XP.dtype, device=XP.device)


def launch_layout(XP, c: ag.AgConsts, opts: LBFGSOptions, bounded=False,
                  layout=None) -> Layout:
    """The layout of a launch on ``XP``: :func:`plan_layout`'s on the card
    that holds it, or, for tests and measurements, the one with the flags
    ``layout``."""
    B, n = XP.shape
    if layout is None:
        sms = torch.cuda.get_device_properties(
            XP.device).multi_processor_count
        layout = plan_layout(ag.ring_cols(c), n, opts.m, XP.dtype, bounded,
                             B, sms).flags
    return layout_of(int(layout), ag.ring_cols(c), n, opts.m, XP.dtype,
                     bounded)


def _check_bounds(lower, upper, XP):
    """Both bounds as contiguous tensors of XP's dtype on its device,
    (n_dof,) or (B, n_dof); (None, None) when unbounded."""
    if lower is None and upper is None:
        return None, None
    out = []
    for v, fill in ((lower, -np.inf), (upper, np.inf)):
        t = (torch.full(XP.shape[1:], fill, dtype=XP.dtype,
                        device=XP.device) if v is None
             else torch.as_tensor(v).to(device=XP.device, dtype=XP.dtype))
        if tuple(t.shape) not in (tuple(XP.shape[1:]), tuple(XP.shape)):
            raise ValueError(f"bounds must be (n_dof,) or (B, n_dof) = "
                             f"{tuple(XP.shape)}; got {tuple(t.shape)}")
        out.append(t.contiguous())
    return tuple(out)


def _count_rule(key):
    RULE_LAUNCHES[key] = RULE_LAUNCHES.get(key, 0) + 1


def _count_model(key):
    MODEL_LAUNCHES[key] = MODEL_LAUNCHES.get(key, 0) + 1


def solve_kernel(XP, rf, c: ag.AgConsts, opts: LBFGSOptions, lower=None,
                 upper=None, _layout=None):
    """Launch K2 on ``XP`` (B, n_dof), a CUDA tensor of ``c``'s dtype on
    ``c``'s device: one block per member solves the rung under ``c.disc``
    at a scalar or (N_f-1, D) ``rf``, inside the box ``lower``/``upper``
    ((n_dof,) or (B, n_dof), ±inf for a free side) when given, in
    :func:`plan_layout`'s layout (``_layout``: other flags, for tests and
    measurements; the results are the same bits in every layout). Returns
    an LBFGSResult on PyTorch's current stream, without synchronizing.
    Raises on anything the kernel does not take and on a refused
    launch."""
    global RUNG_LAUNCHES
    _check_input(XP, c, opts)
    rf_s, rfd = ag._rf_arg(rf, c)
    XP = XP.contiguous()
    B = XP.shape[0]
    lo, hi = _check_bounds(lower, upper, XP)
    bnd = ((None, None, 0) if lo is None else
           (lo.data_ptr(), hi.data_ptr(), XP.shape[1] if lo.ndim == 2
            else 0))
    X = torch.empty_like(XP)
    G = torch.empty_like(XP)
    fp = torch.empty(B, 2, dtype=XP.dtype, device=XP.device)
    cnt = torch.empty(B, 3, dtype=torch.int32, device=XP.device)
    if B:
        lay = launch_layout(XP, c, opts, lo is not None, _layout)
        launch_k2(XP, rf_s, rfd, c, opts, lay, bnd, X, G, fp, cnt)
        RUNG_LAUNCHES += 1
        _count_key("K2", c, rfd)
    return LBFGSResult(x=X, f=fp[:, 0], g=G, niter=cnt[:, 0],
                       nfev=cnt[:, 1], status=cnt[:, 2], pgnorm=fp[:, 1])


def _count_key(kernel, c: ag.AgConsts, rfd):
    """Count a launch of ``kernel`` ("K2", "K3" or "K8") in
    :data:`MODEL_LAUNCHES` (a row-level model) or :data:`RULE_LAUNCHES`
    (Lorenz-96 under another rule or an (N_f-1, D) rf); Lorenz-96's
    trapezoid rule with a scalar rf counts in neither."""
    if c.model != "l96":
        _count_model(f"{kernel}/"
                     + ag.model_key(c.model, c.disc, rfd is not None))
    elif _is_rule(c, rfd):
        _count_rule(f"{kernel}/" + ag.rule_key(c.disc, rfd is not None))


def launch_k2(XP, rf_s, rfd, c: ag.AgConsts, opts: LBFGSOptions,
              lay: Layout, bnd, X, G, fp, cnt):
    """One launch of K2's entry for ``c`` (the trapezoid rule with a
    scalar rf, another rule or rf kind, or a row-level model) on ``XP``
    (B, n_dof), contiguous, B >= 1, in the layout ``lay``, the box ``bnd``
    (lo, hi, stride) and the scalar rf ``rf_s`` or the (N_f-1, D) rf
    ``rfd``, into the outputs X, G, fp, cnt. Counts nothing; raises on a
    refused launch. K8 (kernels/solve_pack.py) launches K2 here for its
    packs of 1–2 off the trapezoid rule with a scalar rf."""
    rule = _is_rule(c, rfd)
    work = _workspace(XP, lay)
    lib = _lib(rule, c.dtype, c.model)
    f32 = c.dtype == torch.float32
    if c.model != "l96":
        fn = getattr(lib, f"va_{c.model}_solve_{_sfx(c.dtype)}")
        rf_args = (rf_s,)
    elif rule:
        fn = lib.va_l96_solve_rule_f32 if f32 else lib.va_l96_solve_rule_f64
        rf_args = (ag.DISCS[c.disc], rf_s,
                   None if rfd is None else rfd.data_ptr())
    else:
        fn = lib.va_l96_solve_f32 if f32 else lib.va_l96_solve_f64
        rf_args = (rf_s,)
    with torch.cuda.device(XP.device):
        stream = torch.cuda.current_stream(XP.device).cuda_stream
        rc = fn(*_common_args(XP, c, opts, rfd), lay.flags, *rf_args, *bnd,
                work.data_ptr(), X.data_ptr(), G.data_ptr(), fp.data_ptr(),
                cnt.data_ptr(), stream)
    _raise_on(rc, lib, "rung-solve")


def ladder_kernel(XP, rfs, c: ag.AgConsts, opts: LBFGSOptions,
                  _layout=None):
    """Launch K3 on ``XP`` (B, n_dof): one block per member runs every
    rung of ``rfs`` (k,) (a tensor of ``c``'s dtype on its device),
    warm-started, under ``c.disc``. ``_layout`` as for
    :func:`solve_kernel`. Returns (XP_out, records) on PyTorch's current
    stream, without synchronizing."""
    global LADDER_LAUNCHES
    _check_input(XP, c, opts)
    if (rfs.dtype != c.dtype or rfs.device != c.device or rfs.ndim != 1
            or rfs.shape[0] < 1):
        raise ValueError("rfs must be a (k,) tensor, k >= 1, of the "
                         "kernel's dtype on its device")
    XP = XP.contiguous()
    rfs = rfs.contiguous()
    B, k = XP.shape[0], rfs.shape[0]
    X = torch.empty_like(XP)
    rec = torch.empty(B, k, 3, dtype=XP.dtype, device=XP.device)
    rec_i = torch.empty(B, k, 3, dtype=torch.int32, device=XP.device)
    if B:
        lay = launch_layout(XP, c, opts, False, _layout)
        work = _workspace(XP, lay)
        rule = _is_rule(c, None)
        lib = _lib(rule, c.dtype, c.model)
        f32 = c.dtype == torch.float32
        if c.model != "l96":
            fn = getattr(lib, f"va_{c.model}_ladder_{_sfx(c.dtype)}")
            disc = ()
        elif rule:
            fn = lib.va_l96_ladder_rule_f32 if f32 else \
                lib.va_l96_ladder_rule_f64
            disc = (ag.DISCS[c.disc],)
        else:
            fn = lib.va_l96_ladder_f32 if f32 else lib.va_l96_ladder_f64
            disc = ()
        with torch.cuda.device(XP.device):
            stream = torch.cuda.current_stream(XP.device).cuda_stream
            rc = fn(*_common_args(XP, c, opts), lay.flags, *disc,
                    rfs.data_ptr(), k, work.data_ptr(), X.data_ptr(),
                    rec.data_ptr(), rec_i.data_ptr(), stream)
        _raise_on(rc, lib, "ladder")
        LADDER_LAUNCHES += 1
        _count_key("K3", c, None)
    recs = dict(A=rec[..., 0], ME=rec[..., 1], FE=rec[..., 0] - rec[..., 1],
                pgnorm=rec[..., 2], niter=rec_i[..., 0], nfev=rec_i[..., 1],
                status=rec_i[..., 2])
    return X, recs


class _Consts:
    """K1's constants per dtype, built at first use on one device."""

    def __init__(self, spec, device):
        self.spec = spec
        self.device = device
        self._by_dtype = {}

    def __call__(self, dtype):
        if dtype not in self._by_dtype:
            self._by_dtype[dtype] = ag.ag_consts(self.spec, self.device,
                                                 dtype)
        return self._by_dtype[dtype]


def _check_envelope(spec, rf, opts):
    if not any(solve_supported(spec, rf, opts, dtype=dt)
               for dt in ag._DTYPES):
        raise ValueError(f"problem outside the solve kernels' envelope: "
                         f"{solve_refusal(spec, rf, opts)} (see "
                         f"solve_supported); use opt.lbfgs_minimize")


def flat_bounds(spec: ProblemSpec, lower, upper, device):
    """``bounds(XP) -> (lo, hi)``: flat (n_dof,) bounds (a missing side
    and ±inf entries free) as tensors of XP's dtype on ``device``, made
    once per dtype; (None, None) when both are None. Raises unless each
    given bound is flat (n_dof,)."""
    box = None
    if lower is not None or upper is not None:
        n = spec.n_dof
        box = tuple(np.full(n, fill) if v is None
                    else np.asarray(v, np.float64).reshape(-1)
                    for v, fill in ((lower, -np.inf), (upper, np.inf)))
        if any(b.shape != (n,) for b in box):
            raise ValueError(f"bounds must be flat (n_dof,) = ({n},)")
    box_t = {}

    def bounds(XP):
        if box is None:
            return None, None
        if XP.dtype not in box_t:
            box_t[XP.dtype] = tuple(
                torch.as_tensor(b, device=device).to(XP.dtype) for b in box)
        return box_t[XP.dtype]

    return bounds


def make_rung_solver(spec: ProblemSpec, opts: LBFGSOptions, lower=None,
                     upper=None, device=None):
    """Build ``solve(XP, rf) -> LBFGSResult`` running the whole L-BFGS
    rung solve in one launch (one block per member of ``XP`` (B, n_dof)):
    the ``rung_solver=`` hook of ``anneal.run_ladder``. ``rf``: a scalar
    or the rung's (N_f-1, D) rf. ``lower``/``upper``: flat (n_dof,)
    bounds as ``api.build_bounds`` gives them (a missing side and ±inf
    entries are free); the kernel then runs the projection algorithm.
    ``device=None`` means the CUDA card. Raises outside
    :func:`solve_supported`."""
    _check_envelope(spec, 0.0, opts)
    consts = _Consts(spec, resolve_device(device))
    bounds = flat_bounds(spec, lower, upper, consts.device)

    def solve(XP, rf):
        c = consts(XP.dtype)
        lo, hi = bounds(XP)
        rf = float(rf) if np.ndim(rf) == 0 else rf
        if XP.device.type == "cpu":
            if XP.device != c.device:
                raise ValueError(f"XP is on {XP.device}; the solver is on "
                                 f"{c.device}")
            return solve_reference(XP, rf, c, opts, lo, hi)
        return solve_kernel(XP, rf, c, opts, lo, hi)

    solve.consts = consts
    return solve


#: The reference's cap on the padded grid (N_pad <= 1024) for
#: ``solver='auto'``: where it measured the whole-solve kernel at least at
#: parity with the generic loop on the TPU. Kept as the reference's
#: policy; the H100 measurement at larger N is queued (ROADMAP.md).
PREFERRED_MAX_N_PAD = 1024
#: The reference's cap on the history for ``solver='auto'``: its
#: ``solve_supported`` refuses m > 8 (``solve_pallas.py:216``), so its
#: ``solve_preferred`` keeps m = 9..16 on the generic loop; the port's
#: kernels take up to :data:`MAX_M` under ``solver='fused'``.
PREFERRED_MAX_M = 8


def solve_preferred(spec: ProblemSpec, rf, opts: LBFGSOptions,
                    dtype=torch.float32, device=None) -> bool:
    """``solver='auto'`` takes the rung-solve kernel: on the card, in
    float32, inside :func:`solve_supported`, with m at most
    :data:`PREFERRED_MAX_M` and the grid padded to 8 rows at most
    :data:`PREFERRED_MAX_N_PAD` (the reference's policy: its
    ``solve_supported`` asks ``ag_supported``, which takes float32 only,
    so float64 stays on the generic loop; ``solver='fused'`` takes K2 in
    float64 too). False off the card, as the reference's is off the
    TPU."""
    return (resolve_device(device).type == "cuda"
            and dtype == torch.float32
            and opts.m <= PREFERRED_MAX_M
            and solve_supported(spec, rf, opts, dtype=dtype)
            and -(-spec.N_f // 8) * 8 <= PREFERRED_MAX_N_PAD)


def pick_rung_solver(spec: ProblemSpec, rf0, opts: LBFGSOptions, *,
                     solver="auto", lower=None, upper=None,
                     dtype=torch.float32, compensated=False, engine="auto",
                     method="L-BFGS-B", device=None):
    """The facade's ``solver=`` gate (``solve_pallas.pick_rung_solver``,
    same policy): returns a rung solver (:func:`make_rung_solver`) or None
    for the generic loop.

    - ``'auto'``: the kernel inside :func:`solve_preferred`, for method
      L-BFGS-B/LBFGS, not compensated; an explicit engine other than
      ``'auto'``/``'ag'`` or ``bounded_algo='subspace'`` with bounds pins
      the generic loop;
    - ``'fused'``: the kernel wherever :func:`solve_supported` holds (on
      the CPU its plain version), else a warning and the generic loop;
    - ``'generic'``: always None."""
    if solver not in ("auto", "generic", "fused"):
        raise ValueError(f"solver must be auto/generic/fused, got "
                         f"{solver!r}")
    if solver == "generic":
        return None
    if solver == "auto":
        ok = solve_preferred(spec, rf0, opts, dtype=dtype, device=device)
    else:
        ok = solve_supported(spec, rf0, opts, dtype=dtype)
    ok = ok and method in ("L-BFGS-B", "LBFGS") and not compensated
    if ok and solver == "auto" and engine not in ("auto", "ag"):
        ok = False
    if (ok and (lower is not None or upper is not None)
            and opts.bounded_algo == "subspace"):
        ok = False
    if ok:
        return make_rung_solver(spec, opts, lower=lower, upper=upper,
                                device=device)
    if solver == "fused":
        why = (solve_refusal(spec, rf0, opts, dtype)
               or ("compensated" if compensated else None)
               or (f"method {method!r}"
                   if method not in ("L-BFGS-B", "LBFGS") else None)
               or "bounded_algo='subspace' with bounds")
        warnings.warn(
            f"solver='fused' unsupported for this problem: {why}; using "
            f"the generic solver", stacklevel=3)
    return None


def make_ladder_solver(spec: ProblemSpec, opts: LBFGSOptions, n_rungs: int,
                       device=None):
    """Build ``ladder(XP, rfs) -> (XP_out, records)`` running ``n_rungs``
    warm-started scalar-rf unbounded solves in one launch (one block per
    member of ``XP`` (B, n_dof)), under the problem's rule. ``rfs``: the
    (n_rungs,) rung values (the caller computes them, as
    ``anneal.ladder.rung_rf`` does). ``records``:
    dict of (B, n_rungs) tensors A, ME, FE = A - ME, pgnorm, niter, nfev,
    status, A being the action at the rung's minimizer. ``device=None``
    means the CUDA card. Raises outside :func:`ladder_supported`."""
    _check_envelope(spec, 0.0, opts)
    k = int(n_rungs)
    if k < 1:
        raise ValueError("n_rungs must be at least 1")
    consts = _Consts(spec, resolve_device(device))

    def ladder(XP, rfs):
        c = consts(XP.dtype)
        rfs_np = np.asarray(rfs, dtype=np.float64).reshape(-1)
        if rfs_np.shape[0] != k:
            raise ValueError(f"expected {k} rung values, got "
                             f"{rfs_np.shape[0]}")
        if XP.device.type == "cpu":
            if XP.device != c.device:
                raise ValueError(f"XP is on {XP.device}; the solver is on "
                                 f"{c.device}")
            return ladder_reference(XP, rfs_np, c, opts)
        rfs_t = torch.as_tensor(rfs_np, device=XP.device).to(XP.dtype)
        return ladder_kernel(XP, rfs_t, c, opts)

    ladder.consts = consts
    return ladder
