"""Config system: a frozen dataclass mirroring ``Annealer.anneal``'s kwargs
so that runs are reproducible from a JSON file, and the loader used by the
``python -m varanneal_tpu_torch`` runner.

A copy of ``varanneal_tpu/config.py`` (the port imports nothing of the JAX
package): the same fields, the same ``{"stop": ...}`` shorthand for
``beta_array`` and the same unknown-key check. Every field corresponds to
an ``anneal`` kwarg, and ``AnnealConfig.run(annealer, X0, P0)`` is exactly
``annealer.anneal(X0, P0, **fields)``.
"""

import dataclasses
import json
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnnealConfig:
    """Mirror of ``Annealer.anneal(...)`` keyword arguments."""
    alpha: float
    beta_array: Sequence[float]
    RM: Any
    RF0: Any
    Lidx: Sequence[int]
    Pidx: Optional[Sequence[int]] = None
    dt_model: Optional[float] = None
    init_to_data: bool = True
    action: str = "A_gaussian"
    disc: str = "trapezoid"
    method: str = "L-BFGS-B"
    bounds: Optional[List[Tuple[float, float]]] = None
    opt_args: Optional[dict] = None
    adolcID: int = 0
    track_paths: bool = True
    verbose: bool = False
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 10
    resume: bool = True
    R_time_dependent: Optional[bool] = None
    engine: str = "auto"
    repeats: int = 1
    snapshot_beta: Optional[int] = None
    checkpoint_meta: Optional[dict] = None
    compensated: bool = False

    def run(self, annealer, X0, P0, **overrides):
        kw = dataclasses.asdict(self)
        kw.update(overrides)
        kw["beta_array"] = np.asarray(kw["beta_array"])
        if kw["bounds"] is not None:
            kw["bounds"] = [tuple(b) for b in kw["bounds"]]
        return annealer.anneal(X0, P0, **kw)

    @classmethod
    def from_json(cls, path: str) -> "AnnealConfig":
        with open(path) as fh:
            raw = json.load(fh)
        # beta_array may be given as {"start": ..., "stop": ...}
        b = raw.get("beta_array")
        if isinstance(b, dict):
            raw["beta_array"] = list(range(int(b.get("start", 0)),
                                           int(b["stop"])))
        known = {f.name for f in dataclasses.fields(cls)}
        # runner-level keys live alongside the anneal kwargs in one file
        unknown = set(raw) - known - {"model", "data", "comment", "P0",
                                      "X0", "out"}
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**{k: v for k, v in raw.items() if k in known})
