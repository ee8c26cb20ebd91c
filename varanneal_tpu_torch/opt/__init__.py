"""Batched optimizers."""

from varanneal_tpu_torch.opt.lbfgs import (
    lbfgs_minimize, LBFGSOptions, LBFGSResult)
from varanneal_tpu_torch.opt.tnc import tnc_minimize, TNCOptions

__all__ = ["lbfgs_minimize", "LBFGSOptions", "LBFGSResult",
           "tnc_minimize", "TNCOptions"]
