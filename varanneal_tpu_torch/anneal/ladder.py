"""The precision-annealing β ladder as a Python loop over rungs.

Counterpart of ``varanneal_tpu/anneal/ladder.py`` (``LadderResult``,
``run_ladder``). For each β the action is minimized at RF = RF0·α^β,
warm-started from the previous β's minimizer, and A/ME/FE, the solver's
status, niter, nfev and pgnorm are recorded. A failed inner solve is
recorded, not retried. The JAX package runs the rungs under ``lax.scan``;
PyTorch runs eagerly, so here they are a loop whose carry is the batch of
decision vectors.

``rf_max``/``rf_min``, ``aggregate_repeats``, the other inner solvers and
``rung_solver`` wait for later slices (ROADMAP.md).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.ops.action import value_and_grad
from varanneal_tpu_torch.opt.lbfgs import LBFGSOptions, lbfgs_minimize


class LadderResult(NamedTuple):
    XP: torch.Tensor        # (B, n_dof) final minimizers
    A: torch.Tensor         # (B, Nbeta) action at each β's minimizer
    ME: torch.Tensor        # (B, Nbeta)
    FE: torch.Tensor        # (B, Nbeta)
    status: torch.Tensor    # (B, Nbeta) raw L-BFGS status codes
    niter: torch.Tensor     # (B, Nbeta)
    nfev: torch.Tensor      # (B, Nbeta) action+grad evaluations
    pgnorm: torch.Tensor    # (B, Nbeta)
    paths: Optional[torch.Tensor]   # (B, Nbeta, n_dof) if stored


def rung_rf(rf0, alpha, beta, dtype):
    """RF0·α^β computed on the host in ``dtype``, as the JAX ladder
    computes it from ``dtype`` operands. Returns a Python float for a
    scalar RF0, else a float64 NumPy array rounded to ``dtype``."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    rf = (np.asarray(rf0, np_dt)
          * np.asarray(alpha, np_dt) ** np.asarray(beta, np_dt))
    rf = np.asarray(rf, np_dt)
    return float(rf) if rf.ndim == 0 else rf.astype(np.float64)


def run_ladder(action, action_parts, XP0, betas, rf0, alpha, *,
               lower=None, upper=None, opts: Optional[LBFGSOptions] = None,
               store_paths: bool = True, device=None) -> LadderResult:
    """Run the annealing ladder from the initial decision vectors ``XP0``
    ((B, n_dof), or (n_dof,) for one member, whose records then drop the
    batch axis). ``action`` is batched (``ops.action.make_action`` or
    ``kernels.ag.make_action_ag``); an action that carries its own
    ``value_and_grad`` is evaluated through it, so the fused kernel's
    single launch serves every evaluation. ``device=None`` means the CUDA
    card."""
    opts = opts or LBFGSOptions()
    if lower is not None or upper is not None:
        raise NotImplementedError(
            "bounded ladders wait for a later slice of the port; see "
            "ROADMAP.md")
    device = resolve_device(device)
    XP = torch.as_tensor(XP0).to(device)
    one = XP.ndim == 1
    if one:
        XP = XP[None]
    vag = value_and_grad(action)
    recs = {k: [] for k in ("A", "ME", "FE", "status", "niter", "nfev",
                            "pgnorm", "paths")}
    for beta in np.asarray(betas).reshape(-1):
        rf = rung_rf(rf0, alpha, beta, XP.dtype)
        rf_t = rf if isinstance(rf, float) else torch.as_tensor(
            rf, device=device).to(XP.dtype)
        res = lbfgs_minimize(lambda z: vag(z, rf_t), XP, opts=opts,
                             device=device)
        XP = res.x
        with torch.no_grad():
            A, me, fe = action_parts(XP, rf_t)
        for k, v in (("A", A), ("ME", me), ("FE", fe),
                     ("status", res.status), ("niter", res.niter),
                     ("nfev", res.nfev), ("pgnorm", res.pgnorm)):
            recs[k].append(v)
        if store_paths:
            recs["paths"].append(XP)
    out = {k: torch.stack(v, dim=1) if v else None for k, v in recs.items()}
    res = LadderResult(XP=XP, **out)
    if one:
        res = LadderResult(*(None if t is None else t[0] for t in res))
    return res
