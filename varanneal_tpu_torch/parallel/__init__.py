"""Ensembles of initial conditions and the draw-anchored prior."""

from varanneal_tpu_torch.parallel.ensemble import (
    draw_anchored_problem, make_ensemble_ladder, random_ensemble_inits,
    strip_anchors)

__all__ = ["draw_anchored_problem", "make_ensemble_ladder",
           "random_ensemble_inits", "strip_anchors"]
