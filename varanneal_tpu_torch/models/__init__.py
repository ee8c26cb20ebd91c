"""Vector fields f(t, x, p) in PyTorch (the model-call convention of
``varanneal_tpu/models``)."""

from varanneal_tpu_torch.models.lorenz import lorenz96, lorenz63

__all__ = ["lorenz96", "lorenz63"]
