"""Lorenz-63 and Lorenz-96 vector fields in PyTorch.

Counterpart of ``varanneal_tpu/models/lorenz.py`` (``lorenz96``,
``lorenz63``). The model-call convention is the same: ``f(t, x, p)`` with
``x`` of shape ``(..., D)`` and ``p`` of shape ``(NP,)`` or broadcastable
to ``(..., NP)``. The TPU-only ``.transposed`` variant of Lorenz-96 is not
ported: it served a Pallas layout that the card does not need.
"""

import torch


def _pcol(p, j):
    """Parameter column j of p (``(NP,)`` or ``(..., NP)``), broadcastable
    against x of shape (..., D)."""
    if p.ndim == 0:
        return p
    if p.ndim == 1:
        return p[j]
    return p[..., j:j + 1]


def lorenz96(t, x, p):
    """Lorenz-96: dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F; p = [F].

    Rolls along the state axis, vectorized over any leading time/batch
    shape."""
    xp1 = torch.roll(x, -1, dims=-1)
    xm2 = torch.roll(x, 2, dims=-1)
    xm1 = torch.roll(x, 1, dims=-1)
    return (xp1 - xm2) * xm1 - x + _pcol(p, 0)


def lorenz63(t, x, p):
    """Lorenz-63: p = [sigma, rho, beta]."""
    sigma, rho, beta = _pcol(p, 0), _pcol(p, 1), _pcol(p, 2)
    x0, x1, x2 = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    dx0 = sigma * (x1 - x0)
    dx1 = x0 * (rho - x2) - x1
    dx2 = x0 * x1 - beta * x2
    return torch.cat([dx0, dx1, dx2], dim=-1)
