"""Vector fields f(t, x, p) in PyTorch (the model-call convention of
``varanneal_tpu/models``)."""

from varanneal_tpu_torch.models.lorenz import lorenz96, lorenz63
from varanneal_tpu_torch.models.nakl import (
    nakl, nakl_param_boxes, nakl_log_model, nakl_ss_gates,
    nakl_ensemble_inits, NAKL_P_TRUE, NAKL_PNAMES, NAKL_PBOUNDS,
    NAKL_STATE_BOUNDS, NAKL_TAU_IDX, NAKL_G_IDX)
from varanneal_tpu_torch.models.colpitts import (
    colpitts, COLPITTS_P_TRUE, COLPITTS_PNAMES)

__all__ = ["lorenz96", "lorenz63", "nakl", "nakl_param_boxes",
           "nakl_log_model", "nakl_ss_gates", "nakl_ensemble_inits",
           "NAKL_P_TRUE", "NAKL_PNAMES", "NAKL_PBOUNDS",
           "NAKL_STATE_BOUNDS", "NAKL_TAU_IDX", "NAKL_G_IDX",
           "colpitts", "COLPITTS_P_TRUE", "COLPITTS_PNAMES"]
