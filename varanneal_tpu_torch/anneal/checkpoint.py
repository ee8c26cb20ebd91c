"""Checkpoint / resume for long annealing runs, with per-rung repeats and a
β snapshot.

Counterpart of ``varanneal_tpu/anneal/checkpoint.py`` (``_atomic_savez``,
``_meta_matches``, ``_load_resume``, ``run_ladder_checkpointed``). The
warm-start state across β is the batch of decision vectors, so the ladder
checkpoints itself: the dispatches run in chunks of ``save_every``, each
chunk one call of ``anneal.ladder.run_ladder`` over its β values, and
after every chunk the decision vectors and the per-dispatch records land
in an atomically replaced ``.npz``. A preempted run resumes from the last
completed chunk; the arithmetic of a chunk does not depend on where the
run started, so the continuation is bit-identical.

- ``repeats=R``: every rung is re-minimized R times, warm-started, one
  dispatch each; the records come back per rung
  (``ladder.aggregate_repeats``). ``skip_converged_repeats`` skips the
  remaining repeats of a rung once every member exits gradient-converged
  (status 0 only: a re-dispatch would not move), duplicating its records
  with zero niter/nfev columns.
- ``snapshot_beta=k``: the decision vectors right after rung k completes
  all its repeats (``LadderResult.snapshot``). Chunks are split at the
  snapshot, so it never drifts past the requested rung.
- ``meta=dict``: run-identity scalars stored in the checkpoint and
  validated on resume; a checkpoint written under other settings is
  ignored and the run starts fresh.

The file is the reference's format v3, with the same npz keys
(``n_beta``, ``betas``, ``next_idx``, ``repeats``, ``treedef``,
``n_leaves``, ``xp0``, the seven record fields, ``meta_*``,
``n_snap_leaves``/``snap0``, ``n_path_leaves``/``path0``), and the
reference's treedef string for a bare array (:data:`FLAT_TREEDEF`). So
the file is how ladder state crosses between the two packages: a flat or
batched checkpoint written by either resumes in the other, and files in
the reference's v1 and v2 formats resume too. The nnet facade
checkpoints its flat vector (``nnet.py``, as the reference's does). The
one tree-shaped decision variable, the time-sharded tree of
``parallel/timeshard.py``, waits for ROADMAP.md §1 item 9.
"""

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.anneal.ladder import (LadderResult,
                                               aggregate_repeats, run_ladder)
from varanneal_tpu_torch.opt.lbfgs import LBFGSOptions

_FIELDS = ("A", "ME", "FE", "status", "niter", "nfev", "pgnorm")

#: The treedef string the reference records for a bare array decision
#: variable (``str(jax.tree_util.tree_structure(np.zeros(3)))``), flat
#: (n_dof,) or batched (B, n_dof).
FLAT_TREEDEF = "PyTreeDef(*)"


def _atomic_savez(path, **arrays):
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        # write through the fd: np.savez(path) would append ".npz" and the
        # rename would move an empty file
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _meta_matches(z, meta, verbose):
    """Compare user run-identity metadata against the checkpoint's."""
    for k, v in (meta or {}).items():
        key = f"meta_{k}"
        if key not in z.files:
            if verbose:
                print(f"[checkpoint] missing meta key {k!r}")
            return False
        if not np.array_equal(np.asarray(z[key]), np.asarray(v)):
            if verbose:
                print(f"[checkpoint] meta mismatch on {k!r}: "
                      f"{z[key]} != {v}")
            return False
    return True


def _load_resume(z, n_disp, disp_betas, shape0, store_paths, batched, meta,
                 verbose):
    """Validate a checkpoint file against this run; return (next_idx, XP,
    records, paths, snapshot), NumPy, or None if it belongs to another
    ladder or holds a tree-shaped decision variable."""
    if int(z["n_beta"]) != n_disp or not np.allclose(z["betas"], disp_betas):
        return None
    if not _meta_matches(z, meta, verbose):
        return None
    if "XP" in z.files:                      # format v1: flat vector only
        if batched:
            return None
        xp = z["XP"]
    else:
        if ("treedef" not in z.files or str(z["treedef"]) != FLAT_TREEDEF
                or int(z["n_leaves"]) != 1):
            return None
        xp = z["xp0"]
    if xp.shape != shape0:
        return None
    recs = {k: [np.asarray(z[k])] for k in _FIELDS}
    paths = None
    if store_paths:
        if "paths" in z.files:               # v1
            paths = [np.asarray(z["paths"])]
        elif "n_path_leaves" in z.files:
            paths = [np.asarray(z["path0"])]
        else:
            return None
    snap = np.asarray(z["snap0"]) if "n_snap_leaves" in z.files else None
    return int(z["next_idx"]), np.asarray(xp), recs, paths, snap


def run_ladder_checkpointed(action, action_parts, XP0, betas, rf0, alpha, *,
                            ckpt_path: Optional[str] = None,
                            save_every: int = 10,
                            lower=None, upper=None,
                            opts: Optional[LBFGSOptions] = None,
                            store_paths: bool = True,
                            resume: bool = True,
                            verbose: bool = False,
                            batched: bool = False,
                            batched_bounds: bool = False,
                            repeats: int = 1,
                            snapshot_beta: Optional[int] = None,
                            meta: Optional[dict] = None,
                            skip_converged_repeats: bool = True,
                            device=None,
                            **ladder_kwargs) -> LadderResult:
    """Drop-in for :func:`run_ladder` with chunked dispatch, per-chunk
    checkpointing, per-rung repeats and a β snapshot (see the module
    docstring).

    ``XP0``: the flat decision vector (n_dof,), or with ``batched=True``
    a batch (B, n_dof) whose records come back (B, Nβ). ``ckpt_path``:
    the ``.npz`` updated after every chunk of ``save_every`` dispatches
    (None: chunked execution without persistence). ``resume=True``:
    continue from an existing checkpoint, validated against the β
    ladder, the decision variable's structure and shape, and ``meta``;
    False overwrites it. ``batched_bounds=True`` (with ``batched``):
    ``lower``/``upper`` are (B, n_dof), one box per member. The other
    keyword arguments (``inner``, ``residual_fn``, ``lm_opts``,
    ``tnc_opts``, ``rf_max``, ``rf_min``, ``rung_solver``)
    go to :func:`run_ladder`. Returns per-rung records as tensors on the
    ladder's device; ``result.snapshot`` holds the snapshot (or None).
    ``device=None`` means the CUDA card."""
    if isinstance(XP0, dict):
        raise NotImplementedError(
            "tree-shaped decision variables (the time-sharded tree, "
            "ROADMAP.md §1 item 9) wait for a later slice of the port; see "
            "ROADMAP.md, 'Modules still to port'")
    opts = opts or LBFGSOptions()
    device = resolve_device(device)
    XP = torch.as_tensor(XP0).to(device)
    if XP.ndim != (2 if batched else 1):
        raise ValueError(
            f"XP0 must be {'(B, n_dof)' if batched else '(n_dof,)'} with "
            f"batched={batched}; got shape {tuple(XP.shape)}")
    betas = np.asarray(betas)
    n_rung = len(betas)
    repeats = max(1, int(repeats))
    disp_betas = np.repeat(betas, repeats)
    n_disp = len(disp_betas)
    snap_disp = None
    if snapshot_beta is not None:
        if not 0 < snapshot_beta <= n_rung:
            raise ValueError(
                f"snapshot_beta must be in (0, {n_rung}], got "
                f"{snapshot_beta}")
        snap_disp = int(snapshot_beta) * repeats
    rec_ax = 1 if batched else 0             # the β axis of the records

    start = 0
    recs = {k: [] for k in _FIELDS}
    paths = None                             # NumPy chunks of the paths
    snap = None

    if ckpt_path is not None and resume and os.path.exists(ckpt_path):
        with np.load(ckpt_path, allow_pickle=False) as z:
            state = _load_resume(z, n_disp, disp_betas, tuple(XP.shape),
                                 store_paths, batched, meta, verbose)
        if state is not None:
            start, xp, recs, paths, snap = state
            XP = torch.as_tensor(xp, device=device)
            if verbose:
                print(f"[checkpoint] resuming at dispatch index {start} "
                      f"from {ckpt_path}")
        elif verbose:
            print(f"[checkpoint] {ckpt_path} is for a different run; "
                  "starting fresh")

    if batched_bounds:
        if not batched:
            raise ValueError("batched_bounds requires batched=True")
        if lower is None or upper is None:
            raise ValueError("batched_bounds requires lower and upper")
        lower = torch.as_tensor(lower)
        upper = torch.as_tensor(upper)
        if lower.ndim != 2 or upper.ndim != 2:
            raise ValueError("batched_bounds takes (B, n_dof) lower and "
                             "upper")

    i = start
    while i < n_disp:
        end = min(i + save_every, n_disp)
        if snap_disp is not None and i < snap_disp < end:
            end = snap_disp        # never drift past the snapshot rung
        res = run_ladder(action, action_parts, XP, disp_betas[i:end], rf0,
                         alpha, lower=lower, upper=upper, opts=opts,
                         store_paths=store_paths, device=device,
                         **ladder_kwargs)
        XP = res.XP
        for k in _FIELDS:
            recs[k].append(getattr(res, k).cpu().numpy())
        if store_paths:
            if paths is None:
                paths = []
            paths.append(res.paths.cpu().numpy())
        i = end
        if skip_converged_repeats and repeats > 1 and i % repeats != 0 \
                and i < n_disp:
            last_st = np.take(recs["status"][-1], -1, axis=rec_ax)
            if np.all(last_st == 0):          # CONV_GRAD only (stationary)
                rung_end = ((i - 1) // repeats + 1) * repeats
                nskip = rung_end - i
                for k in _FIELDS:
                    col = np.take(recs[k][-1], [-1], axis=rec_ax)
                    if k in ("niter", "nfev"):
                        col = np.zeros_like(col)
                    recs[k].append(np.repeat(col, nskip, axis=rec_ax))
                if store_paths:
                    col = np.take(paths[-1], [-1], axis=rec_ax)
                    paths.append(np.repeat(col, nskip, axis=rec_ax))
                i = rung_end
        if snap_disp is not None and i == snap_disp:
            snap = XP.cpu().numpy()

        if ckpt_path is not None:
            payload = dict(
                n_beta=n_disp, betas=disp_betas, next_idx=i,
                repeats=repeats, treedef=FLAT_TREEDEF, n_leaves=1,
                xp0=XP.cpu().numpy(),
                **{k: np.concatenate(recs[k], axis=rec_ax)
                   for k in _FIELDS},
                **{f"meta_{k}": np.asarray(v)
                   for k, v in (meta or {}).items()})
            if snap is not None:
                payload["n_snap_leaves"] = 1
                payload["snap0"] = snap
            if store_paths:
                payload["n_path_leaves"] = 1
                payload["path0"] = np.concatenate(paths, axis=rec_ax)
            _atomic_savez(ckpt_path, **payload)
        if verbose:
            a_min = float(np.min(np.asarray(recs["A"][-1])[..., -1]))
            where = f" saved -> {ckpt_path}" if ckpt_path else ""
            print(f"[checkpoint] dispatch {i}/{n_disp} "
                  f"A_min={a_min:.6g}{where}", flush=True)

    def cat(chunks):
        return torch.as_tensor(np.concatenate(chunks, axis=rec_ax),
                               device=device)

    res = LadderResult(
        XP=XP, **{k: cat(recs[k]) for k in _FIELDS},
        paths=cat(paths) if store_paths else None)
    res = aggregate_repeats(res, n_rung, repeats, rec_ax=rec_ax)
    return res._replace(
        snapshot=None if snap is None else torch.as_tensor(snap,
                                                           device=device))
