"""Precision-annealing ladder."""

from varanneal_tpu_torch.anneal.ladder import (run_ladder, LadderResult,
                                               aggregate_repeats)
from varanneal_tpu_torch.anneal.checkpoint import run_ladder_checkpointed

__all__ = ["run_ladder", "LadderResult", "aggregate_repeats",
           "run_ladder_checkpointed"]
