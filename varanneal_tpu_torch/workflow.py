"""Staged ensemble estimation: the NaKL campaign's recipe as one library
entry point, on the card.

Counterpart of ``varanneal_tpu/workflow.py`` (``phase1``, ``polish``,
``estimate``, ``Phase1Result``/``PolishResult``/``EstimateResult``,
``safe_polish_batch``, the ``_dispatch`` seam). The recipe: draw an
ensemble from (optionally tight) prior boxes, optionally anchor each
member's parameters to its own draw with a weak MAP prior
(``parallel.draw_anchored_problem``), run the f32 screening ladder in
checkpointed chunks with per-rung repeats and a pre-divergence
snapshot, rank the members by action, strip the anchors, and polish the
top members in f64 in sequential batches (``examples/nakl_ensemble.py``
drives it). The checkpoint files keep the reference's names
(``<stem>_p1_ckpt.npz``, ``<stem>_pol_ckpt.npz``,
``<stem>_pol{i}_ckpt.npz``) and format, so a campaign resumes across the
two packages.

Three things differ from the reference, on purpose:

- :func:`safe_polish_batch` returns 0 (no split): the TPU worker's crash
  at B = 6 that the reference guards against has no counterpart here;
- a polish dispatch is retried only after a fault classified as
  transient by its type alone (:func:`_is_transient`): the card running
  out of memory. The reference also retries any RuntimeError whose text
  holds a marker such as "worker" or "INTERNAL"; here a RuntimeError,
  which is what a kernel wrapper raises on a failed launch, re-raises at
  once, so that a retry never hides a kernel's fault;
- the solver gate (``kernels.solve.pick_rung_solver``) is given the
  run's ``compensated`` flag, which the reference's gate never sees.

Arrays come back as NumPy. ``device=None`` means the CUDA card.
"""

import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.anneal.checkpoint import run_ladder_checkpointed
from varanneal_tpu_torch.opt.lbfgs import LBFGSOptions
from varanneal_tpu_torch.parallel.ensemble import (draw_anchored_problem,
                                                   strip_anchors)

# dispatch seam: polish()'s retry loop calls this; tests replace it to
# inject faults
_dispatch = run_ladder_checkpointed

_PROGRAMMING = (TypeError, ValueError, KeyError, AttributeError,
                AssertionError, NotImplementedError)


def _is_transient(e: BaseException) -> bool:
    """A dispatch failure worth a retry: the card out of memory (another
    process held it for a while). By type only: a programming error
    (TypeError, ValueError, KeyError, AttributeError, AssertionError,
    NotImplementedError) never is, and neither is any other RuntimeError,
    which is how a kernel wrapper reports a failed launch."""
    if isinstance(e, _PROGRAMMING):
        return False
    return isinstance(e, torch.cuda.OutOfMemoryError)


def _np(a):
    """An array argument as NumPy (a tensor is copied to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _torch_dtype(dtype):
    return torch.float32 if np.dtype(dtype) == np.float32 else torch.float64


def _maybe_rung_solver(spec, rf0, opts, solver, rung_solver, lower,
                       upper, dtype, anchored=False, compensated=False,
                       device=None):
    """The workflow's side of the facade's solver gate
    (``kernels.solve.pick_rung_solver``), with the run's ``compensated``
    flag. An explicit ``rung_solver`` wins; anchored problems pin the
    generic loop (the whole-rung kernel's in-kernel action cannot see the
    anchor penalty)."""
    if rung_solver is not None:
        return rung_solver
    if spec is None or solver == "generic":
        return None
    if anchored:
        if solver == "fused":
            warnings.warn(
                "solver='fused' is unavailable for anchor_weight > 0 "
                "(the fused kernel evaluates the raw spec action, not "
                "the anchored one); using the generic solver",
                stacklevel=3)
        return None
    from varanneal_tpu_torch.kernels.solve import pick_rung_solver
    opts = opts or LBFGSOptions()
    return pick_rung_solver(spec, _np(rf0), opts, solver=solver,
                            lower=lower, upper=upper,
                            dtype=_torch_dtype(dtype),
                            compensated=compensated, device=device)


def safe_polish_batch() -> int:
    """Members per polish dispatch known to be safe: 0, no limit (the
    reference's TPU worker crashed at B = 6; the card has no such
    envelope, and the reference returns 0 off the TPU too)."""
    return 0


class Phase1Result(NamedTuple):
    XP: np.ndarray          # (B, n[+n_params anchors]) final states
    A: np.ndarray           # (B, n_rungs) per-rung actions
    ME: np.ndarray
    FE: np.ndarray
    status: np.ndarray
    niter: np.ndarray
    nfev: np.ndarray
    snapshot: Optional[np.ndarray]   # (B, n...) state at snapshot_beta
    order: np.ndarray       # members sorted by final-rung action
    anchored: bool          # XP/snapshot carry anchor coordinates


def phase1(action, parts, xp0, betas, rf0, alpha, *, lower=None,
           upper=None, opts: Optional[LBFGSOptions] = None,
           n_params: int = 0, anchor_weight: float = 0.0,
           anchor_width: float = 0.25, repeats: int = 1,
           snapshot_beta: Optional[int] = None,
           checkpoint_stem: Optional[str] = None, save_every: int = 2,
           rf_min=None, rf_max=None, meta: Optional[dict] = None,
           spec=None, solver: str = "auto", rung_solver=None,
           compensated: bool = False, device=None,
           verbose: bool = False) -> Phase1Result:
    """The screening ladder: (optionally own-draw-anchored) batched
    annealing in checkpointed chunks of ``save_every`` dispatches, with
    per-rung ``repeats``, an optional pre-divergence ``snapshot_beta``
    and the checkpoint ``checkpoint_stem + '_p1_ckpt.npz'``.

    ``xp0``: (B, n) ensemble of packed decision vectors whose trailing
    ``n_params`` coordinates are the estimated parameters.
    ``anchor_weight > 0`` anchors each member's parameters to its own
    draw (``parallel.draw_anchored_problem``); ``XP`` and ``snapshot``
    then carry the anchor centers as extra trailing coordinates
    (``anchored=True``). ``spec``/``solver``/``rung_solver``/
    ``compensated``: the facade's solver gate
    (``kernels.solve.pick_rung_solver``; anchored screens take the
    generic loop). ``device=None`` means the CUDA card."""
    xp0 = _np(xp0)
    if xp0.ndim != 2:
        raise ValueError(f"xp0 must be (B, n), got {xp0.shape}")
    device = resolve_device(device)
    anchored = bool(anchor_weight)
    lo_run, hi_run = lower, upper
    if anchored:
        if not n_params:
            raise ValueError("anchor_weight requires n_params > 0")
        action, parts, xp0, lo_run, hi_run = draw_anchored_problem(
            action, parts, xp0, np.asarray(lower), np.asarray(upper),
            n_params=n_params, weight=anchor_weight, width=anchor_width)
    rung_solver = _maybe_rung_solver(spec, rf0, opts, solver,
                                     rung_solver, lower, upper,
                                     xp0.dtype, anchored=anchored,
                                     compensated=compensated, device=device)
    res = run_ladder_checkpointed(
        action, parts, xp0, betas, rf0, alpha,
        ckpt_path=(checkpoint_stem + "_p1_ckpt.npz"
                   if checkpoint_stem else None),
        save_every=save_every, lower=lo_run, upper=hi_run, opts=opts,
        store_paths=False, batched=True, batched_bounds=anchored,
        repeats=repeats, snapshot_beta=snapshot_beta, meta=meta,
        verbose=verbose, rf_min=rf_min, rf_max=rf_max,
        rung_solver=rung_solver, device=device)
    A = _np(res.A)
    return Phase1Result(
        XP=_np(res.XP), A=A, ME=_np(res.ME), FE=_np(res.FE),
        status=_np(res.status), niter=_np(res.niter), nfev=_np(res.nfev),
        snapshot=None if res.snapshot is None else _np(res.snapshot),
        order=np.argsort(A[:, -1]), anchored=anchored)


class PolishResult(NamedTuple):
    XP: np.ndarray          # (K, n) polished states, in ``picks`` order
    A: np.ndarray           # (K, n_rungs) per-rung polish actions
    picks: np.ndarray       # member indices polished (into phase-1 batch)
    order: np.ndarray       # rows of XP sorted by final polished action


def polish(action, parts, src, betas, rf0, alpha, *, lower=None,
           upper=None, opts: Optional[LBFGSOptions] = None,
           picks=None, anchored_n_params: int = 0,
           batch: Optional[int] = None, repeats: int = 1,
           checkpoint_stem: Optional[str] = None, save_every: int = 2,
           rf_min=None, rf_max=None, dtype=np.float64,
           meta: Optional[dict] = None,
           spec=None, solver: str = "auto", rung_solver=None,
           compensated: bool = False, retries: int = 2,
           retry_wait: float = 30.0, device=None,
           verbose: bool = False) -> PolishResult:
    """The accuracy-grade stage: re-anneal the selected members up the
    top rungs at ``dtype`` (f64 by default), in sequential member batches
    of at most ``batch`` per dispatch (None: :func:`safe_polish_batch`,
    no split; 0 or less: one batch).

    ``src``: (B, n) phase-1 states (the snapshot if one was taken);
    ``picks``: member indices to polish (default: every row).
    ``anchored_n_params > 0`` strips that many anchor coordinates first
    (the polish is prior-free). Checkpoints per batch at
    ``checkpoint_stem + '_pol_ckpt.npz'`` / ``'_pol{i}_ckpt.npz'``. A
    batch whose dispatch fails with a transient fault
    (:func:`_is_transient`) is dispatched again up to ``retries`` more
    times after ``retry_wait`` seconds, resuming from its checkpoint;
    any other fault re-raises at once. ``spec``/``solver``/
    ``rung_solver``/``compensated``: the solver gate at the polish
    dtype."""
    src = _np(src)
    if picks is None:
        picks = np.arange(src.shape[0])
    picks = [int(k) for k in np.asarray(picks).ravel()]
    src_p = src[picks]
    if anchored_n_params:
        src_p = strip_anchors(src_p, anchored_n_params)
    K = len(picks)
    if batch is None:
        batch = safe_polish_batch()
    pbatch = int(batch) if batch and batch > 0 else K
    device = resolve_device(device)
    np_dtype = np.dtype(dtype)
    rung_solver = _maybe_rung_solver(spec, rf0, opts, solver,
                                     rung_solver, lower, upper, np_dtype,
                                     compensated=compensated, device=device)
    XP_parts, A_parts = [], []
    for bi in range(0, K, pbatch):
        sel = list(range(bi, min(bi + pbatch, K)))
        ck = None
        if checkpoint_stem:
            ck = checkpoint_stem + ("_pol_ckpt.npz" if bi == 0
                                    else f"_pol{bi}_ckpt.npz")
        if verbose and K > pbatch:
            print(f"[workflow] polish batch [{sel[0]}:{sel[-1] + 1}] "
                  f"of {K}")
        bmeta = dict(meta or {})
        bmeta["picks"] = np.asarray([picks[j] for j in sel])
        for attempt in range(int(retries) + 1):
            try:
                res = _dispatch(
                    action, parts, src_p[sel].astype(np_dtype), betas, rf0,
                    alpha, ckpt_path=ck,
                    save_every=max(int(save_every), 1), lower=lower,
                    upper=upper, opts=opts, store_paths=False,
                    batched=True, repeats=repeats, meta=bmeta,
                    verbose=verbose, rf_min=rf_min, rf_max=rf_max,
                    rung_solver=rung_solver, device=device)
                break
            except Exception as e:
                if attempt >= int(retries) or not _is_transient(e):
                    raise
                if verbose:
                    print(f"[workflow] polish batch [{sel[0]}:"
                          f"{sel[-1] + 1}] transient fault "
                          f"({type(e).__name__}); retry "
                          f"{attempt + 1}/{retries} in {retry_wait:g}s"
                          f"{' (resume from ' + ck + ')' if ck else ''}",
                          flush=True)
                time.sleep(retry_wait)
        XP_parts.append(_np(res.XP))
        A_parts.append(_np(res.A))
    XP = np.concatenate(XP_parts, axis=0)
    A = np.concatenate(A_parts, axis=0)
    return PolishResult(XP=XP, A=A, picks=np.asarray(picks),
                        order=np.argsort(A[:, -1]))


class EstimateResult(NamedTuple):
    phase1: Phase1Result
    polish: Optional[PolishResult]
    best: np.ndarray        # polished (or phase-1) winner, anchors
    #                         stripped: the final estimate vector
    best_A: float
    best_member: int        # index into the phase-1 ensemble


def estimate(make_problem, xp0, betas, rf0, alpha, *, n_params: int,
             opts: Optional[LBFGSOptions] = None,
             anchor_weight: float = 0.0, anchor_width: float = 0.25,
             repeats: int = 1, snapshot_beta: Optional[int] = None,
             polish_top: int = 4, polish_batch: Optional[int] = None,
             polish_opts: Optional[LBFGSOptions] = None,
             polish_repeats: int = 1, polish_extra_betas: int = 10,
             polish_dtype=np.float64,
             checkpoint_stem: Optional[str] = None, save_every: int = 2,
             rf_min=None, rf_max=None, meta: Optional[dict] = None,
             solver: str = "auto", compensated: bool = False,
             polish_retries: int = 2, device=None,
             verbose: bool = False) -> EstimateResult:
    """The whole staged recipe in one call: prior-box ensemble, own-draw
    anchors, the chunked f32 screening ladder (and snapshot), action
    ranking, anchors stripped, the batch-split f64 polish of the top
    members.

    ``make_problem(dtype) -> (action, parts, lower, upper)`` builds the
    (possibly multi-protocol) problem at a NumPy dtype, the screening
    dtype (``xp0.dtype``) and the polish dtype; it may return a 5-tuple
    whose last entry is the ``ProblemSpec`` for the solver gate
    (``solver``, ``compensated``). ``xp0``: (B, n) ensemble whose
    trailing ``n_params`` coordinates are the estimated parameters.
    ``snapshot_beta``: the rung whose state seeds the polish (default:
    the final state). ``polish_top=0`` skips the polish. The polish
    continues the ladder in β-value space: from the source state's rung
    value, then ``polish_extra_betas`` rungs at the ladder's own
    spacing."""
    xp0 = _np(xp0)
    p1_dtype = xp0.dtype
    device = resolve_device(device)

    def _build(dt):
        out = make_problem(dt)
        return out if len(out) == 5 else tuple(out) + (None,)

    action, parts, lower, upper, spec = _build(p1_dtype)
    r1 = phase1(action, parts, xp0, betas, rf0, alpha, lower=lower,
                upper=upper, opts=opts, n_params=n_params,
                anchor_weight=anchor_weight, anchor_width=anchor_width,
                repeats=repeats, snapshot_beta=snapshot_beta,
                checkpoint_stem=checkpoint_stem, save_every=save_every,
                rf_min=rf_min, rf_max=rf_max, meta=meta,
                spec=spec, solver=solver, compensated=compensated,
                device=device, verbose=verbose)
    nap = n_params if r1.anchored else 0
    if not polish_top:
        b = int(r1.order[0])
        best = r1.XP[b]
        if nap:
            best = strip_anchors(best, nap)
        return EstimateResult(phase1=r1, polish=None, best=best,
                              best_A=float(r1.A[b, -1]), best_member=b)
    betas = np.asarray(_np(betas), np.float64)
    n_beta = len(betas)
    if r1.snapshot is not None:
        # rank at the snapshot rung; the polish climbs snap..top+extra
        c = min(int(snapshot_beta) - 1, r1.A.shape[1] - 1)
        order_pol = np.argsort(r1.A[:, c])
        src = r1.snapshot
        lo_rung = int(snapshot_beta)
    else:
        order_pol = r1.order
        src = r1.XP
        lo_rung = max(n_beta - 21, 0)
    picks = order_pol[: min(int(polish_top), src.shape[0])]
    # continue the ladder in β-value space (rung indices and β values
    # coincide only for unit-spaced 0-based ladders)
    step = float(betas[-1] - betas[-2]) if n_beta > 1 else 1.0
    extra = betas[-1] + step * np.arange(1, int(polish_extra_betas) + 1)
    pol_betas = np.concatenate([betas[lo_rung:], extra])
    action64, parts64, lo64, hi64, spec64 = _build(polish_dtype)
    rf0_64 = np.asarray(_np(rf0), polish_dtype)
    r2 = polish(action64, parts64, src, pol_betas, rf0_64, alpha,
                lower=lo64, upper=hi64, opts=polish_opts, picks=picks,
                anchored_n_params=nap, batch=polish_batch,
                repeats=polish_repeats, checkpoint_stem=checkpoint_stem,
                save_every=save_every, rf_min=rf_min, rf_max=rf_max,
                dtype=polish_dtype, spec=spec64, solver=solver,
                compensated=compensated, retries=polish_retries,
                device=device, verbose=verbose)
    j = int(r2.order[0])
    return EstimateResult(phase1=r1, polish=r2, best=r2.XP[j],
                          best_A=float(r2.A[j, -1]),
                          best_member=int(r2.picks[j]))
