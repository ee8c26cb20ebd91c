"""Ensembles of initial conditions on one device.

Counterpart of ``varanneal_tpu/parallel/ensemble.py``
(``make_ensemble_ladder`` without a mesh, ``random_ensemble_inits``,
``draw_anchored_problem``, ``strip_anchors``). The JAX package ``vmap``s
the ladder over members; the port's ladder is batched already, so an
ensemble is the rows of one (B, n_dof) tensor. ``random_ensemble_inits``
is a NumPy copy that makes the same draws, so a seed gives the same
members in both packages. Mesh sharding across cards waits for a later
slice (ROADMAP.md).
"""

from typing import Optional

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.anneal.ladder import run_ladder
from varanneal_tpu_torch.opt.lbfgs import LBFGSOptions
from varanneal_tpu_torch.ops.spec import ProblemSpec


def make_ensemble_ladder(action, action_parts, betas, rf0, alpha, *,
                         lower=None, upper=None,
                         opts: Optional[LBFGSOptions] = None,
                         store_paths: bool = False, device=None,
                         **ladder_kwargs):
    """Build a function mapping a batch of initial decision vectors
    (B, n_dof) to a batched LadderResult (records (B, Nbeta)) on one
    device. ``lower``/``upper`` and the other keyword arguments
    (``rf_max``/``rf_min``, ``rung_solver``, the whole-rung kernel of
    ``kernels.solve.make_rung_solver``, and ``inner`` with its
    ``residual_fn``/``lm_opts``/``tnc_opts``) are passed to
    ``run_ladder``. ``device=None`` means the CUDA card."""
    opts = opts or LBFGSOptions()
    device = resolve_device(device)

    def batched(xp0):
        return run_ladder(action, action_parts, xp0, betas, rf0, alpha,
                          lower=lower, upper=upper, opts=opts,
                          store_paths=store_paths, device=device,
                          **ladder_kwargs)

    return batched


def random_ensemble_inits(spec: ProblemSpec, n_members: int, seed: int = 0,
                          lo: float = -10.0, hi: float = 10.0,
                          init_to_data: bool = True, dtype=np.float64,
                          state_sampler=None, param_sampler=None):
    """Reference-style ensemble initialization: uniform random paths with
    observed components optionally clamped to the data, shared P_base
    initial parameters. Returns (B, n_dof).

    Fully vectorized (one batched pack, no per-member Python loop — matters
    at B=4096+). Custom init distributions:

    - ``state_sampler(rng, shape)`` -> (B, N_f, D) initial paths
      (default: uniform on [lo, hi));
    - ``param_sampler(rng, shape)`` -> (B, n_par) estimated-parameter
      initials (default: every member starts at P_base's estimated entries).
    """
    rng = np.random.default_rng(seed)
    B = n_members
    sample = state_sampler or (lambda r, shape: r.uniform(lo, hi, shape))
    X0 = np.asarray(sample(rng, (B, spec.N_f, spec.D)), dtype=np.float64)
    if X0.shape != (B, spec.N_f, spec.D):
        raise ValueError(
            f"state_sampler returned {X0.shape}, expected "
            f"{(B, spec.N_f, spec.D)}")
    if init_to_data:
        obs = np.arange(spec.N_data) * spec.obs_stride
        X0[:, obs[:, None], np.asarray(spec.Lidx)[None, :]] = spec.Y
    parts = [X0.reshape(B, spec.n_state)]
    if spec.n_par:
        if param_sampler is not None:
            pe = np.asarray(param_sampler(rng, (B, spec.n_par)),
                            dtype=np.float64)
            if pe.shape != (B, spec.n_par):
                raise ValueError(
                    f"param_sampler returned {pe.shape}, expected "
                    f"{(B, spec.n_par)}")
        else:
            P = np.asarray(spec.P_base)
            pcols = np.asarray(spec.pidx)
            base = (P[:, pcols].reshape(-1) if spec.time_dep_p
                    else P[pcols])
            pe = np.broadcast_to(base, (B, spec.n_par))
        parts.append(pe)
    return np.concatenate(parts, axis=1).astype(dtype) if len(parts) > 1 \
        else parts[0].astype(dtype)


def draw_anchored_problem(action, action_parts, xp_batch, lower, upper, *,
                          n_params: int, weight: float, width: float = 0.25,
                          freeze_eps: float = 1e-5):
    """Draw-anchored weak MAP prior (multi-start regularized annealing):
    each member's trailing ``n_params`` parameter coordinates are softly
    anchored to the member's own initial draw by the penalty
    ``weight * sum(((p - p_draw) / (width * box_width))**2)``.

    The anchor centers travel inside the decision vector as ``n_params``
    extra trailing coordinates, frozen by a degenerate per-member box
    (half-width ``freeze_eps`` of each parameter box, and at least one
    representable step of the target dtype past the center): run the
    result through ``run_ladder_checkpointed(..., batched=True,
    batched_bounds=True)``. The wrapped actions are batched, as the
    port's actions are: xp (..., n_dof + n_params).

    Args: ``xp_batch`` (B, n_dof) initial decision vectors (NumPy) with
    the parameters as the trailing ``n_params`` coordinates;
    ``lower``/``upper`` flat (n_dof,) bounds in estimation scale. Returns
    ``(action', parts', xp' (B, n_dof + n_params), lower' (B, ...),
    upper' (B, ...))``, the last three NumPy."""
    xp_batch = np.asarray(xp_batch)
    if xp_batch.ndim != 2:
        raise ValueError(f"xp_batch must be (B, n_dof), got {xp_batch.shape}")
    B, n_dof = xp_batch.shape
    npar = int(n_params)
    if not 0 < npar <= n_dof:
        raise ValueError(f"n_params={npar} out of range for n_dof={n_dof}")
    lo = np.asarray(lower, np.float64)
    hi = np.asarray(upper, np.float64)
    if lo.shape != (n_dof,) or hi.shape != (n_dof,):
        raise ValueError("lower/upper must be flat (n_dof,) arrays")
    wdt = hi[-npar:] - lo[-npar:]
    if np.any(wdt <= 0):
        raise ValueError("parameter bounds must have positive width")
    dtype = xp_batch.dtype
    cen = xp_batch[:, -npar:].astype(np.float64)
    xp_ext = np.concatenate([xp_batch, cen.astype(dtype)], axis=1)
    # the freeze box in the target dtype: cen ± eps·wdt can round to cen
    # itself, so each side is widened to at least one representable step
    c_t = cen.astype(dtype)
    lo_a = np.minimum(np.asarray(cen - freeze_eps * wdt, dtype),
                      np.nextafter(c_t, np.asarray(-np.inf, dtype)))
    hi_a = np.maximum(np.asarray(cen + freeze_eps * wdt, dtype),
                      np.nextafter(c_t, np.asarray(np.inf, dtype)))
    lo_ext = np.concatenate(
        [np.tile(lo, (B, 1)).astype(dtype), lo_a], axis=1)
    hi_ext = np.concatenate(
        [np.tile(hi, (B, 1)).astype(dtype), hi_a], axis=1)

    iw2_np = 1.0 / (width * wdt) ** 2
    consts = {}

    def _pen(xp):
        key = (xp.device, xp.dtype)
        if key not in consts:
            consts[key] = (
                torch.tensor(float(weight), dtype=xp.dtype,
                             device=xp.device),
                torch.as_tensor(iw2_np, device=xp.device).to(xp.dtype))
        lam, iw2 = consts[key]
        dp = xp[..., -2 * npar:-npar] - xp[..., -npar:]
        return lam * torch.sum(iw2 * dp * dp, dim=-1)

    def action_a(xp, rf):
        return action(xp[..., :-npar], rf) + _pen(xp)

    def parts_a(xp, rf):
        a, me, fe = action_parts(xp[..., :-npar], rf)
        return a + _pen(xp), me, fe

    return action_a, parts_a, xp_ext, lo_ext, hi_ext


def strip_anchors(xp, n_params: int):
    """Drop the anchor-center coordinates added by
    :func:`draw_anchored_problem` (the last ``n_params`` of the trailing
    axis), before a prior-free polish on the standard problem."""
    return np.asarray(xp)[..., :-int(n_params)]
