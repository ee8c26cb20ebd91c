"""The precision-annealing β ladder as a Python loop over rungs.

Counterpart of ``varanneal_tpu/anneal/ladder.py`` (``LadderResult``,
``run_ladder``). For each β the action is minimized at RF = RF0·α^β,
warm-started from the previous β's minimizer, and A/ME/FE, the solver's
status, niter, nfev and pgnorm are recorded. A failed inner solve is
recorded, not retried. The JAX package runs the rungs under ``lax.scan``;
PyTorch runs eagerly, so here they are a loop whose carry is the batch of
decision vectors.

``rung_solver`` replaces the inner minimizer, as in the JAX ladder (the
whole-rung kernel K2, ``kernels.solve.make_rung_solver``). ``inner``
picks the minimizer otherwise: the L-BFGS family (``opt.lbfgs``, bounded
by ``lower``/``upper``), Levenberg–Marquardt over a residual function
(``opt.lm``), truncated Newton (``opt.tnc``) or nonlinear CG
(``opt.ncg``, unbounded). ``rf_max``/``rf_min`` cap and floor each
rung's precision. :func:`aggregate_repeats` collapses the per-dispatch
records of a ladder whose rungs were re-minimized several times
(``anneal/checkpoint.py``) to per-rung records.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.ops.action import value_and_grad
from varanneal_tpu_torch.opt.lbfgs import LBFGSOptions, lbfgs_minimize
from varanneal_tpu_torch.opt.lm import LMOptions, lm_minimize
from varanneal_tpu_torch.opt.ncg import NCGOptions, ncg_minimize
from varanneal_tpu_torch.opt.tnc import TNCOptions, autograd_hvp, tnc_minimize


class LadderResult(NamedTuple):
    XP: torch.Tensor        # (B, n_dof) final minimizers
    A: torch.Tensor         # (B, Nbeta) action at each β's minimizer
    ME: torch.Tensor        # (B, Nbeta)
    FE: torch.Tensor        # (B, Nbeta)
    status: torch.Tensor    # (B, Nbeta) raw solver status codes
    niter: torch.Tensor     # (B, Nbeta)
    nfev: torch.Tensor      # (B, Nbeta) action+grad evaluations
    pgnorm: torch.Tensor    # (B, Nbeta)
    paths: Optional[torch.Tensor]   # (B, Nbeta, n_dof) if stored
    snapshot: Optional[torch.Tensor] = None   # decision vectors after
    #                         ``snapshot_beta`` rungs (anneal/checkpoint.py)


def aggregate_repeats(res: LadderResult, n_rung: int, repeats: int,
                      rec_ax: int = 0) -> LadderResult:
    """Collapse per-dispatch records (each rung re-minimized ``repeats``
    times, warm-started) to per-rung records, the β axis of the records
    being ``rec_ax`` (1 for a batch of members): A/ME/FE/status/pgnorm
    and the paths take each rung's last repeat, niter/nfev sum over its
    repeats."""
    if repeats == 1:
        return res

    def _reshape(a):
        shp = (tuple(a.shape[:rec_ax]) + (n_rung, repeats)
               + tuple(a.shape[rec_ax + 1:]))
        return a.reshape(shp)

    def _last(a):
        return _reshape(a).select(rec_ax + 1, repeats - 1)

    def _sum(a):
        return _reshape(a).sum(dim=rec_ax + 1, dtype=a.dtype)

    paths = None if res.paths is None else _last(res.paths)
    return res._replace(
        A=_last(res.A), ME=_last(res.ME), FE=_last(res.FE),
        status=_last(res.status), pgnorm=_last(res.pgnorm),
        niter=_sum(res.niter), nfev=_sum(res.nfev), paths=paths)


def rung_rf(rf0, alpha, beta, dtype, rf_min=None, rf_max=None):
    """RF(β) = min(max(RF0·α^β, rf_min), rf_max) in ``dtype`` on the host,
    the cap applied last. α^β is computed in double precision and rounded
    to ``dtype`` before the product, which gives the values XLA's
    ``rf0 * alpha ** beta`` gives on ``dtype`` operands on the CPU (the
    JAX ladder, ``varanneal_tpu/anneal/ladder.py``): held equal at every
    β of the bench's 0..100 in f32 and f64 by
    ``tests/test_torch_ladder.py``. Returns a Python float for a scalar
    result, else a float64 NumPy array of ``dtype``-rounded values."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    rf = np.asarray(rf0, np_dt) * np_dt(math.pow(float(alpha), float(beta)))
    if rf_min is not None:
        rf = np.maximum(rf, np.asarray(rf_min, np_dt))
    if rf_max is not None:
        rf = np.minimum(rf, np.asarray(rf_max, np_dt))
    rf = np.asarray(rf, np_dt)
    return float(rf) if rf.ndim == 0 else rf.astype(np.float64)


def run_ladder(action, action_parts, XP0, betas, rf0, alpha, *,
               lower=None, upper=None, opts: Optional[LBFGSOptions] = None,
               store_paths: bool = True, inner: str = "lbfgs",
               residual_fn=None, lm_opts=None, tnc_opts=None,
               rf_max=None, rf_min=None, rung_solver=None,
               device=None) -> LadderResult:
    """Run the annealing ladder from the initial decision vectors ``XP0``
    ((B, n_dof), or (n_dof,) for one member, whose records then drop the
    batch axis). ``action`` is batched (``ops.action.make_action`` or
    ``kernels.ag.make_action_ag``); an action that carries its own
    ``value_and_grad`` is evaluated through it, so the fused kernel's
    single launch serves every evaluation. ``rung_solver``: optional
    ``solve(XP, rf) -> LBFGSResult`` replacing the inner minimizer
    entirely (``kernels.solve.make_rung_solver``: one launch per rung);
    the records still come from ``action_parts`` at its minimizer (a
    bounded rung solver carries its own bounds). ``lower``/``upper``: flat
    (n_dof,) box bounds (``api.build_bounds``), ±inf for a free side.
    ``rf_max``/``rf_min``: per-component cap and floor on RF(β), shaped
    like ``rf0`` or broadcastable against it (see :func:`rung_rf`).

    ``inner``: 'lbfgs' (default); 'lm', the matrix-free Gauss–Newton /
    Levenberg–Marquardt solver (``opt.lm``, which needs ``residual_fn(XP,
    rf)``, ``opt.lm.make_residual_fn``; ``lm_opts``); 'tnc', truncated
    Newton with bound projection (``opt.tnc``; ``tnc_opts``, by default
    ``opts``' maxiter, ftol, pgtol and maxls), whose Hessian-vector
    products are the double backward of ``action_parts``' action (the
    autograd action of the problem for the 'xla' and 'ag' engines; K6's
    records, ``action.engine == 'pallas'``, have no second derivative and
    raise); or 'ncg',
    nonlinear CG, unbounded (``opt.ncg``, from ``opts``' maxiter, ftol,
    pgtol and maxls). ``device=None`` means the CUDA card."""
    opts = opts or LBFGSOptions()
    device = resolve_device(device)
    if inner == "lm":
        if residual_fn is None:
            raise ValueError("inner='lm' requires residual_fn")
        lm_opts = lm_opts or LMOptions()
    elif inner == "ncg":
        if lower is not None or upper is not None:
            raise ValueError("inner='ncg' does not support bounds")
        ncg_opts = NCGOptions(maxiter=opts.maxiter, ftol=opts.ftol,
                              pgtol=opts.pgtol, maxls=opts.maxls)
    elif inner == "tnc":
        tnc_opts = tnc_opts or TNCOptions(maxiter=opts.maxiter,
                                          ftol=opts.ftol, pgtol=opts.pgtol,
                                          maxls=opts.maxls)
        if getattr(action, "engine", None) == "pallas":
            raise ValueError(
                "inner='tnc' takes Hessian-vector products by autograd of "
                "action_parts, and K6's (engine='pallas') has no second "
                "derivative; pass engine='xla' or 'ag'")
    elif inner != "lbfgs":
        raise ValueError(f"unknown inner solver {inner!r}")
    XP = torch.as_tensor(XP0).to(device)
    one = XP.ndim == 1
    if one:
        XP = XP[None]
    vag = value_and_grad(action)
    recs = {k: [] for k in ("A", "ME", "FE", "status", "niter", "nfev",
                            "pgnorm", "paths")}
    for beta in np.asarray(betas).reshape(-1):
        rf = rung_rf(rf0, alpha, beta, XP.dtype, rf_min=rf_min,
                     rf_max=rf_max)
        rf_t = rf if isinstance(rf, float) else torch.as_tensor(
            rf, device=device).to(XP.dtype)
        if rung_solver is not None:
            res = rung_solver(XP, rf_t)
        elif inner == "lm":
            res = lm_minimize(lambda z: residual_fn(z, rf_t), XP,
                              lower=lower, upper=upper, opts=lm_opts,
                              device=device)
        elif inner == "ncg":
            res = ncg_minimize(lambda z: vag(z, rf_t), XP, opts=ncg_opts,
                               device=device)
        elif inner == "tnc":
            res = tnc_minimize(
                lambda z: vag(z, rf_t), XP,
                hvp=autograd_hvp(lambda z: action_parts(z, rf_t)[0]),
                lower=lower, upper=upper, opts=tnc_opts, device=device)
        else:
            res = lbfgs_minimize(lambda z: vag(z, rf_t), XP, lower=lower,
                                 upper=upper, opts=opts, device=device)
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
