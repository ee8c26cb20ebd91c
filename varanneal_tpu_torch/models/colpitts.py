"""The Colpitts oscillator vector field in PyTorch.

Counterpart of ``varanneal_tpu/models/colpitts.py`` (``colpitts``,
``COLPITTS_PNAMES``, ``COLPITTS_P_TRUE``): the chaotic 3-state circuit of
the VA literature's twin experiments, in Kennedy's dimensionless form

    dx1/dt = alpha * x2
    dx2/dt = -gamma * (x1 + x3) - q * x2
    dx3/dt = eta * (x2 + 1 - exp(-x1))

with p = [alpha, gamma, q, eta], chaotic at ``COLPITTS_P_TRUE``. The call
convention is the package's ``f(t, x, p)``, vectorized over any leading
time/batch shape. The hand-written device functions of the same field
(f, Jᵀv and the parameter adjoint) are in ``kernels/csrc/colpitts.cuh``.
"""

import torch

from varanneal_tpu_torch.models.lorenz import _pcol

COLPITTS_PNAMES = ["alpha", "gamma", "q", "eta"]
COLPITTS_P_TRUE = [5.0, 0.0797, 0.6898, 6.2723]


def colpitts(t, x, p):
    """Colpitts oscillator; p = [alpha, gamma, q, eta]."""
    alpha, gamma = _pcol(p, 0), _pcol(p, 1)
    q, eta = _pcol(p, 2), _pcol(p, 3)
    x1, x2, x3 = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    dx1 = alpha * x2
    dx2 = -gamma * (x1 + x3) - q * x2
    dx3 = eta * (x2 + 1.0 - torch.exp(-x1))
    return torch.cat([dx1, dx2, dx3], dim=-1)
