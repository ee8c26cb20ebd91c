"""Discretization residual assemblers in PyTorch.

Counterpart of ``varanneal_tpu/ops/disc.py`` (``_f_at``,
``model_residuals``), with the same four residual conventions:

    euler:          g_n = x_{n+1} - x_n - h * f(t_n, x_n)
    trapezoid:      g_n = x_{n+1} - x_n - (h/2) * (f_n + f_{n+1})
    forwardmap:     g_n = x_{n+1} - f(t_n, x_n)          (discrete-time maps)
    SimpsonHermite: on the doubled grid with full interval h over [n, n+2]:
        simpson_n = x_{n+2} - x_n - (h/6) * (f_n + 4 f_{n+1} + f_{n+2})
        hermite_n = x_{n+1} - (x_n + x_{n+2})/2 - (h/8) * (f_n - f_{n+2})

``X`` is ``(..., N_f, D)`` with any leading batch shape. ``P`` is the full
parameter array: ``(..., 1, NP)`` for constant parameters (the singleton
row broadcasts over time) or ``(..., N_f, NP)`` for time-dependent ones.
"""

import torch

from varanneal_tpu_torch.ops.spec import ProblemSpec


def _f_at(spec: ProblemSpec, X, P, sl):
    """Evaluate the vector field on a time-slice ``sl`` of the model grid,
    with time-dependent parameter rows and the stimulus convention
    f(t, x, (p, stim))."""
    x = X[..., sl, :]
    t = torch.as_tensor(spec.t_f, dtype=X.dtype, device=X.device)[sl]
    p = P[..., sl, :] if spec.time_dep_p else P
    if spec.stim_f is not None:
        stim = torch.as_tensor(spec.stim_f, dtype=X.dtype,
                               device=X.device)[sl]
        return spec.f(t, x, (p, stim))
    return spec.f(t, x, p)


def model_residuals(spec: ProblemSpec, X, P):
    """Residual rows for the model-error term.

    Returns (..., N_f-1, D) for euler/trapezoid/forwardmap, or a tuple
    ``(simpson, hermite)`` of two (..., (N_f-1)//2, D) tensors for
    SimpsonHermite.
    """
    h = spec.dt
    if spec.disc == "trapezoid":
        fn = _f_at(spec, X, P, slice(None, -1))
        fnp1 = _f_at(spec, X, P, slice(1, None))
        return X[..., 1:, :] - X[..., :-1, :] - (h / 2.0) * (fn + fnp1)
    if spec.disc == "euler":
        fn = _f_at(spec, X, P, slice(None, -1))
        return X[..., 1:, :] - X[..., :-1, :] - h * fn
    if spec.disc == "forwardmap":
        fn = _f_at(spec, X, P, slice(None, -1))
        return X[..., 1:, :] - fn
    if spec.disc == "SimpsonHermite":
        fn = _f_at(spec, X, P, slice(None, -2, 2))
        fmid = _f_at(spec, X, P, slice(1, -1, 2))
        fnp1 = _f_at(spec, X, P, slice(2, None, 2))
        xe = X[..., :-2:2, :]
        xm = X[..., 1:-1:2, :]
        xo = X[..., 2::2, :]
        simpson = xo - xe - (h / 6.0) * (fn + 4.0 * fmid + fnp1)
        hermite = xm - 0.5 * (xe + xo) - (h / 8.0) * (fn - fnp1)
        return simpson, hermite
    raise ValueError(f"unknown disc {spec.disc!r}")
