"""Nonlinear conjugate gradient (Polak–Ribière+ with automatic restarts),
batched over members.

Counterpart of ``varanneal_tpu/opt/ncg.py`` (``NCGOptions``,
``ncg_minimize``): the strong-Wolfe line search of the L-BFGS solver
(``opt.lbfgs._wolfe_line_search``), unbounded only. The members are the
rows of (B, n) tensors; a member whose loop has ended is frozen (its x,
f, g, direction, niter, nfev and status no longer change), as the
vmapped ``lax.while_loop`` of the JAX package leaves it. Per member the
iterates, niter, nfev and status are the JAX solver's. As in
``opt/lbfgs.py`` the vectors live on the device and the per-member
scalars on the host.
"""

import dataclasses
from typing import Optional

import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.opt.lbfgs import (
    CONV_GRAD, MAXITER, LBFGSOptions, LBFGSResult, _dot, _end_iteration,
    _host, _step, _wolfe_line_search)


@dataclasses.dataclass(frozen=True)
class NCGOptions:
    maxiter: int = 1000
    ftol: float = 2.220446049250313e-09
    pgtol: float = 1e-5
    maxls: int = 30
    c1: float = 1e-4
    c2: float = 0.4          # CG wants a stricter curvature condition


def ncg_minimize(value_and_grad, x0, *, opts: Optional[NCGOptions] = None,
                 device=None) -> LBFGSResult:
    """Minimize each row of ``x0`` ((B, n), or (n,) for one member) given
    ``value_and_grad(x) -> (f (B,), g (B, n))`` with PR+ NCG: the
    direction restarts at -g on non-descent, β = max(gᵀ(g_new - g) / gᵀg,
    0). Stops on max|g| <= pgtol, a relative decrease under ftol, a failed
    line search (status 3, x kept) or maxiter. ``device=None`` means the
    CUDA card."""
    opts = opts or NCGOptions()
    ls_opts = LBFGSOptions(maxls=opts.maxls, c1=opts.c1, c2=opts.c2)
    device = resolve_device(device)
    x = torch.as_tensor(x0).to(device)
    one = x.ndim == 1
    if one:
        x = x[None]
    B = x.shape[0]
    big = torch.finfo(x.dtype).max

    f_dev, g = value_and_grad(x)
    f, pg0 = _host(f_dev, torch.amax(torch.abs(g), dim=-1))
    d = -1.0 * g
    niter = torch.zeros(B, dtype=torch.int32)
    nfev = torch.ones(B, dtype=torch.int32)
    done = pg0 <= opts.pgtol
    status = torch.where(done, CONV_GRAD, MAXITER).to(torch.int32)

    while True:
        run = ~done & (niter < opts.maxiter)
        if not bool(run.any()):
            break
        run_d = run.to(device)[:, None]
        gd = _dot(g, d)
        restart = ((gd >= 0) | ~torch.isfinite(gd))[:, None]
        d = torch.where(restart, -1.0 * g, d)
        gnorm1, dphi0 = _host(torch.sum(torch.abs(g), dim=-1), _dot(g, d))
        a_init = torch.where(
            niter == 0,
            torch.clamp_max(1.0 / torch.clamp_min(gnorm1, 1e-300), 1.0),
            torch.ones_like(gnorm1))
        a, f_new, g_new, ls_nfev, ls_ok = _wolfe_line_search(
            value_and_grad, x, d, f, g, dphi0, a_init, big, ls_opts, run)
        x_new = _step(x, a, d)

        # Polak–Ribière+ β with the automatic restart max(., 0)
        beta = torch.clamp_min(
            _dot(g_new, g_new - g) / torch.clamp_min(_dot(g, g), 1e-300),
            0.0)
        d = torch.where(run_d, -1.0 * g_new + beta[:, None] * d, d)
        pgn = _host(torch.amax(torch.abs(g_new), dim=-1))[0]
        x, g, f, niter, nfev, status, done = _end_iteration(
            opts, run, ls_ok, ls_nfev, pgn, x, x_new, g, g_new, f, f_new,
            niter, nfev, status, done)

    res = LBFGSResult(x=x, f=f.to(device), g=g, niter=niter.to(device),
                      nfev=nfev.to(device), status=status.to(device),
                      pgnorm=torch.amax(torch.abs(g), dim=-1))
    return LBFGSResult(*(t[0] for t in res)) if one else res
