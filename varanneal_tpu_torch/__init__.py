"""varanneal_tpu_torch — the PyTorch/CUDA port of varanneal_tpu.

Variational annealing (VA) for state and parameter estimation in partially
observed nonlinear dynamical systems, ported module by module from the JAX
package ``varanneal_tpu`` (which stays in this repository as the reference)
to PyTorch on an NVIDIA H100. Each TPU kernel on a ported path becomes a
CUDA kernel written by hand for Hopper (``kernels/``), built with nvcc at
first use.

This package imports torch and numpy only: never jax, never any module of
``varanneal_tpu``. Every entry point takes ``device=None``, meaning the
CUDA card, and raises when there is none; pass ``device="cpu"`` to run the
plain PyTorch path. ROADMAP.md lists what is ported and what waits.
"""

__version__ = "0.1.0"

from varanneal_tpu_torch import models, ops, opt, anneal, parallel  # noqa: F401
from varanneal_tpu_torch.twin import lorenz96_twin  # noqa: F401
