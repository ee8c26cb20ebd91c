"""Precision-annealing ladder."""

from varanneal_tpu_torch.anneal.ladder import run_ladder, LadderResult

__all__ = ["run_ladder", "LadderResult"]
