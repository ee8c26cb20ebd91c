"""Batched optimizers."""

from varanneal_tpu_torch.opt.lbfgs import (
    lbfgs_minimize, LBFGSOptions, LBFGSResult)

__all__ = ["lbfgs_minimize", "LBFGSOptions", "LBFGSResult"]
