"""Ensembles of initial conditions on one device.

Counterpart of ``varanneal_tpu/parallel/ensemble.py``
(``make_ensemble_ladder`` without a mesh, ``random_ensemble_inits``). The
JAX package ``vmap``s the ladder over members; the port's ladder is
batched already, so an ensemble is the rows of one (B, n_dof) tensor.
``random_ensemble_inits`` is a NumPy copy that makes the same draws, so a
seed gives the same members in both packages. Mesh sharding across cards
and the draw-anchored prior wait for later slices (ROADMAP.md).
"""

from typing import Optional

import numpy as np

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.anneal.ladder import run_ladder
from varanneal_tpu_torch.opt.lbfgs import LBFGSOptions
from varanneal_tpu_torch.ops.spec import ProblemSpec


def make_ensemble_ladder(action, action_parts, betas, rf0, alpha, *,
                         lower=None, upper=None,
                         opts: Optional[LBFGSOptions] = None,
                         store_paths: bool = False, device=None):
    """Build a function mapping a batch of initial decision vectors
    (B, n_dof) to a batched LadderResult (records (B, Nbeta)) on one
    device. ``device=None`` means the CUDA card."""
    opts = opts or LBFGSOptions()
    device = resolve_device(device)

    def batched(xp0):
        return run_ladder(action, action_parts, xp0, betas, rf0, alpha,
                          lower=lower, upper=upper, opts=opts,
                          store_paths=store_paths, device=device)

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
