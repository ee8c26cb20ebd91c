"""Multi-experiment (multi-protocol) variational annealing in PyTorch.

Counterpart of ``varanneal_tpu/ops/multi.py`` (``_check_specs``,
``make_multi_action``, ``multi_pack``, ``multi_unpack``,
``build_multi_bounds``). K twin experiments of the same model under
different stimulus protocols or observations are annealed jointly,
sharing one estimated-parameter vector; each experiment keeps its own
state path.

- packing: ``XP = concat(X_1.flat, ..., X_K.flat, pest)``, per-experiment
  states in experiment order, shared parameters last;
- the joint action is the mean of the per-experiment actions, so action
  values stay on a single experiment's scale whatever K;
- all specs must agree on (N_f, D, disc, NPest, pidx, P_base) and must
  not use time-dependent parameters; they may differ in Y, RM, stimulus
  and observed indices Lidx.

As the port's single action, the joint action is batched: ``XP`` is
``(..., n_dof)`` and it returns one value per leading index, with one
shared ``rf`` (scalar or canonical (N_f-1, D)) for every experiment.
"""

from typing import Sequence

import numpy as np

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.ops.action import (device_spec, measurement_error,
                                            merge_params, model_error, pack,
                                            rf_arg)
from varanneal_tpu_torch.ops.spec import ProblemSpec


def _check_specs(specs: Sequence[ProblemSpec]):
    if not specs:
        raise ValueError("need at least one spec")
    s0 = specs[0]
    if s0.time_dep_p:
        raise ValueError("multi-experiment with time-dependent parameters "
                         "is not supported")
    for s in specs[1:]:
        if (s.N_f, s.D, s.disc) != (s0.N_f, s0.D, s0.disc):
            raise ValueError(
                "all experiments must share (N_f, D, disc): "
                f"{(s.N_f, s.D, s.disc)} != {(s0.N_f, s0.D, s0.disc)}")
        if s.pidx != s0.pidx or s.time_dep_p:
            raise ValueError("all experiments must share pidx")
        if not np.array_equal(np.asarray(s.P_base), np.asarray(s0.P_base)):
            raise ValueError("all experiments must share P_base")
    return s0


def make_multi_action(specs: Sequence[ProblemSpec], device=None):
    """Joint action over K experiments with shared parameters: ``(action,
    action_parts)`` on the decision vectors ``concat(X_1.flat, ...,
    X_K.flat, pest)`` (..., n_dof); the parts are the K-means of the
    per-experiment (A, ME, FE). ``device=None`` means the CUDA card."""
    s0 = _check_specs(specs)
    K = len(specs)
    n_state = s0.n_state
    device = resolve_device(device)
    cache = {}

    def consts(dtype):
        if dtype not in cache:
            cache[dtype] = [device_spec(s, device, dtype) for s in specs]
        return cache[dtype]

    def action_parts(XP, rf):
        if XP.device != device:
            raise ValueError(f"XP is on {XP.device}, the action on {device}")
        lead = tuple(XP.shape[:-1])
        pest = XP[..., K * n_state:]
        rf_t = rf_arg(rf, XP.dtype, device)
        me_sum = 0.0
        fe_sum = 0.0
        for k, s in enumerate(consts(XP.dtype)):
            X = XP[..., k * n_state: (k + 1) * n_state].reshape(
                lead + (s.N_f, s.D))
            P = merge_params(s, pest)
            me_sum = me_sum + measurement_error(s, X)
            fe_sum = fe_sum + model_error(s, X, P, rf_t)
        me = me_sum / K
        fe = fe_sum / K
        return me + fe, me, fe

    def action(XP, rf):
        return action_parts(XP, rf)[0]

    return action, action_parts


def multi_pack(specs: Sequence[ProblemSpec], Xs: Sequence, P=None):
    """Flatten per-experiment states and one shared parameter set into
    the joint decision vector (NumPy; the shared pest from ``P`` or
    P_base, by the single-experiment packing rule)."""
    s0 = _check_specs(specs)
    if len(Xs) != len(specs):
        raise ValueError(f"need {len(specs)} state paths, got {len(Xs)}")
    tail = pack(s0, np.zeros((s0.N_f, s0.D)), P=P)[s0.n_state:]
    flats = [np.reshape(np.asarray(X), (-1,)) for X in Xs]
    return np.concatenate(flats + [tail])


def multi_unpack(specs: Sequence[ProblemSpec], XP):
    """Joint decision vector(s) (..., n_dof) -> ([X_1, ..., X_K], pest),
    each X_k (..., N_f, D)."""
    s0 = _check_specs(specs)
    n = s0.n_state
    K = len(specs)
    lead = tuple(XP.shape[:-1])
    Xs = [XP[..., k * n: (k + 1) * n].reshape(lead + (s0.N_f, s0.D))
          for k in range(K)]
    return Xs, XP[..., K * n:]


def build_multi_bounds(specs: Sequence[ProblemSpec], bounds, dtype):
    """Per-variable bounds replicated over time and experiments:
    ``bounds`` holds D (lo, hi) state pairs and NPest parameter pairs, as
    ``api.build_bounds``; states repeat once per experiment, parameters
    once at the tail."""
    from varanneal_tpu_torch.api import build_bounds
    s0 = _check_specs(specs)
    lower1, upper1 = build_bounds(s0, bounds, dtype)
    if lower1 is None:
        return None, None
    K = len(specs)
    n = s0.n_state
    lower = np.concatenate([np.tile(lower1[:n], K), lower1[n:]])
    upper = np.concatenate([np.tile(upper1[:n], K), upper1[n:]])
    return lower, upper
