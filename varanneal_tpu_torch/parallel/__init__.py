"""Ensembles of initial conditions."""

from varanneal_tpu_torch.parallel.ensemble import (
    make_ensemble_ladder, random_ensemble_inits)

__all__ = ["make_ensemble_ladder", "random_ensemble_inits"]
