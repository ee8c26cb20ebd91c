"""The action engine policy: which implementation of the action the facade
and the bench evaluate.

Counterpart of ``varanneal_tpu/kernels/fe_pallas.py``'s
``ag_preferred`` and ``select_action`` (and of the part of
``pallas_preferred`` that decides where the time-blocked FE kernels, K6,
would run). The engines:

- ``'xla'``: the autograd action (``ops.action.make_action``);
- ``'ag'``: K1, the fused action+gradient kernel
  (``kernels.ag.make_action_ag``), forced; raises outside its envelope;
- ``'pallas'``: the time-blocked FE kernels (K6), which wait for a later
  slice of the port (ROADMAP.md): raises NotImplementedError;
- ``'auto'``: K1 only in the reference's measured-win regime (a one-step
  disc, D >= 256, float32, on the card); the autograd action below it.
  Inside that regime, where the reference would take a kernel that the
  port does not have yet (K1 for another disc or model, or K6), it
  raises NotImplementedError rather than quietly taking the autograd
  action.
"""

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.kernels import ag
from varanneal_tpu_torch.ops import action as _action
from varanneal_tpu_torch.ops.spec import ProblemSpec

#: The reference's threshold for ``engine='auto'`` (``_AUTO_MIN_D``):
#: its Pallas engines won from D = 256 on, and lost below.
AUTO_MIN_D = 256
_ONE_STEP = ("euler", "trapezoid", "forwardmap")


def _in_regime(spec: ProblemSpec, dtype, device) -> bool:
    return (resolve_device(device).type == "cuda"
            and dtype == torch.float32
            and spec.disc in _ONE_STEP
            and spec.D >= AUTO_MIN_D)


def ag_preferred(spec: ProblemSpec, rf, dtype=torch.float32,
                 device=None) -> bool:
    """``engine='auto'`` takes K1: the reference's regime (a one-step disc,
    D >= :data:`AUTO_MIN_D`, float32, on the card) and K1's envelope."""
    return (_in_regime(spec, dtype, device)
            and ag.ag_supported(spec, rf, dtype))


def _reference_takes_kernel(spec: ProblemSpec, rf) -> bool:
    """Inside the regime the reference runs a kernel (its K1, or K6 through
    ``pallas_preferred``) wherever ``fe_supported`` holds: constant
    parameters, scalar or (N-1, D) rf, a uniform grid."""
    return (not spec.time_dep_p and np.ndim(rf) in (0, 2)
            and ag._uniform_grid(spec))


def select_action(spec: ProblemSpec, rf, engine: str = "auto",
                  dtype=torch.float32, device=None):
    """``(action, action_parts)`` of the chosen engine (see the module
    docstring), with ``action.engine`` set to the engine taken.
    ``device=None`` means the CUDA card."""
    if engine not in ("auto", "xla", "pallas", "ag"):
        raise ValueError(
            f"engine must be auto/xla/pallas/ag, got {engine!r}")
    device = resolve_device(device)
    if engine == "pallas":
        raise NotImplementedError(
            "engine='pallas' (the time-blocked FE kernels, K6) waits for a "
            "later slice of the port; see ROADMAP.md")
    if engine == "ag" and not ag.ag_supported(spec, rf, dtype):
        raise ValueError(
            "engine='ag' unsupported for this problem (K1 takes Lorenz-96 "
            "with the trapezoid rule, constant parameters, scalar rf, "
            "scalar or (N_data, L) RM, float32 or float64; see "
            "kernels.ag.ag_supported)")
    if engine == "auto":
        if ag_preferred(spec, rf, dtype, device):
            engine = "ag"
        elif (_in_regime(spec, dtype, device)
              and _reference_takes_kernel(spec, rf)):
            raise NotImplementedError(
                "engine='auto' at D >= 256 in float32 on the card: the "
                "reference runs its fused kernels here (K1 for this disc "
                "and model, or the FE kernels K6), which wait for a later "
                "slice of the port (ROADMAP.md); pass engine='xla' for "
                "the autograd action")
    if engine == "ag":
        act, parts = ag.make_action_ag(spec, device=device, dtype=dtype)
    else:
        act, parts = _action.make_action(spec, device=device)
        engine = "xla"
    act.engine = engine
    return act, parts
