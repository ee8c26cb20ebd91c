"""Problem spec, discretization residuals and the action."""

from varanneal_tpu_torch.ops.spec import (
    ProblemSpec, build_spec, spec_from_reference, DISC_NAMES)
from varanneal_tpu_torch.ops.disc import model_residuals
from varanneal_tpu_torch.ops.action import (
    make_action, measurement_error, model_error, unpack, pack,
    value_and_grad, comp_sum)

__all__ = [
    "ProblemSpec", "build_spec", "spec_from_reference", "model_residuals",
    "DISC_NAMES", "make_action", "measurement_error", "model_error",
    "unpack", "pack", "value_and_grad", "comp_sum",
]
