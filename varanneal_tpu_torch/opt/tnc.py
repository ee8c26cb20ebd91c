"""Truncated Newton (TNC), batched over members, with box bounds.

Counterpart of ``varanneal_tpu/opt/tnc.py`` (``TNCOptions``,
``_truncated_cg``, ``tnc_minimize``). Each iteration solves the Newton
system H δ = −g by conjugate gradients restricted to the free variables
(bound-active components masked out), truncated on negative curvature
and on the Eisenstat–Walker tolerance min(0.5, √‖g‖)·‖g‖; the line
search is the projected-path Armijo backtracking when bounded and the
strong-Wolfe search otherwise (both shared with ``opt/lbfgs.py``).

Hessian-vector products come from ``hvp(x)``, which returns the product
v -> H(x) v at x for every row; :func:`autograd_hvp` builds it from a
batched objective by double backward (the gradient's graph is built once
an iteration and reused by every CG step). The JAX package takes them by
forward-over-reverse AD of ``value_and_grad``; a kernel's
``value_and_grad`` (K1, K5, K6) has no second derivative in the port, so
the caller names the twice-differentiable function.

The members are the rows of (B, n) tensors. Each member's CG runs its
own iteration count and stops on its own test, in lockstep with the
others; a member whose outer loop has ended is frozen. The CG state lives
on the device, with one read of the members' flags a CG step; the outer
loop's per-member scalars live on the host, as in ``opt/lbfgs.py``.
"""

import dataclasses
from typing import Optional

import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.opt.lbfgs import (
    CONV_FTOL, CONV_GRAD, LS_FAIL, MAXITER, LBFGSOptions, LBFGSResult,
    _bounds, _dot, _frozen, _host, _pgnorm, _projected_backtracking_ls,
    _step, _wolfe_line_search)


@dataclasses.dataclass(frozen=True)
class TNCOptions:
    maxiter: int = 100          # outer Newton iterations
    cg_iters: int = 30          # max CG iterations per Newton solve
    ftol: float = 2.220446049250313e-09
    pgtol: float = 1e-5
    maxls: int = 30
    c1: float = 1e-4
    c2: float = 0.9


def autograd_hvp(fun):
    """``hvp(x)`` for a batched objective ``fun(x (B, n)) -> (B,)``: the
    product v -> ∇²f(x) v per row, by double backward through the
    gradient's graph at x (built once, kept for every product)."""
    def hvp(x):
        with torch.enable_grad():
            z = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(fun(z).sum(), z, create_graph=True)

        def prod(v):
            with torch.enable_grad():
                (Hv,) = torch.autograd.grad(g, z, grad_outputs=v,
                                            retain_graph=True)
            return Hv
        return prod
    return hvp


def _truncated_cg(hvp, g_free, cg_iters, run):
    """CG on H z = −g_free for the members where ``run`` (a device bool
    (B,)) holds, truncated on negative curvature (first-iteration negative
    curvature falls back to steepest descent) and on the Eisenstat–Walker
    tolerance. ``g_free`` must already be masked and ``hvp`` must mask its
    output the same way. Returns (direction, CG iterations used (B,))."""
    dtype = g_free.dtype
    b = -1.0 * g_free
    rs = _dot(b, b)
    bnorm = torch.sqrt(rs)
    tol2 = (torch.clamp_max(torch.sqrt(bnorm), 0.5) * bnorm) ** 2
    z = torch.zeros_like(b)
    r, p = b, b
    i = torch.zeros_like(rs, dtype=torch.int32)
    done = rs <= tol2
    tiny = torch.tensor(1e-300, dtype=dtype, device=b.device)
    while True:
        act = run & ~done & (i < cg_iters)
        if not bool(act.any()):
            break
        Hp = hvp(p)
        curv = _dot(p, Hp)
        neg = (curv <= 0) | ~torch.isfinite(curv)
        alpha = rs / torch.maximum(curv, tiny)
        z_n = z + alpha[:, None] * p
        r_n = r + (-alpha)[:, None] * Hp
        rs_n = _dot(r_n, r_n)
        beta = rs_n / torch.maximum(rs, tiny)
        # the reference's update (``_axpy(beta, r_n, p)``): p + β r_new,
        # not the textbook r_new + β p; kept for parity (ROADMAP.md §3)
        p_n = p + beta[:, None] * r_n
        z_keep = torch.where((i == 0)[:, None], b, z)
        a_, n_ = act[:, None], neg[:, None]
        z = torch.where(a_, torch.where(n_, z_keep, z_n), z)
        r = torch.where(a_ & ~n_, r_n, r)
        p = torch.where(a_ & ~n_, p_n, p)
        rs = torch.where(act & ~neg, rs_n, rs)
        i = i + act.to(torch.int32)
        done = torch.where(act, neg | (rs_n <= tol2), done)
    return z, i


def tnc_minimize(value_and_grad, x0, *, hvp, lower=None, upper=None,
                 opts: Optional[TNCOptions] = None,
                 device=None) -> LBFGSResult:
    """Minimize each row of ``x0`` ((B, n), or (n,) for one member) given
    ``value_and_grad(x) -> (f (B,), g (B, n))`` and ``hvp(x) -> (v ->
    H(x) v)`` (:func:`autograd_hvp`), optionally subject to ``lower <= x
    <= upper`` (flat (n,) or (B, n), ±inf for a free side). Same result
    contract as ``lbfgs_minimize``; ``device=None`` means the CUDA
    card."""
    opts = opts or TNCOptions()
    device = resolve_device(device)
    x = torch.as_tensor(x0).to(device)
    one = x.ndim == 1
    if one:
        x = x[None]
    B = x.shape[0]
    big = torch.finfo(x.dtype).max
    bounded = lower is not None or upper is not None
    lo, hi = _bounds(lower, -big, x), _bounds(upper, big, x)
    ls_opts = LBFGSOptions(maxls=opts.maxls, c1=opts.c1, c2=opts.c2)

    x = torch.clamp(x, lo, hi)
    f_dev, g = value_and_grad(x)
    f, pg0 = _host(f_dev, _pgnorm(x, g, lo, hi))
    use_sd = torch.zeros(B, dtype=torch.bool)
    niter = torch.zeros(B, dtype=torch.int32)
    nfev = torch.ones(B, dtype=torch.int32)
    done = pg0 <= opts.pgtol
    status = torch.where(done, CONV_GRAD, MAXITER).to(torch.int32)

    while True:
        run = ~done & (niter < opts.maxiter)
        if not bool(run.any()):
            break
        run_d = run.to(device)
        # active set and the Newton direction on the free variables
        free = ~_frozen(x, g, lo, hi)
        g_free = torch.where(free, g, 0.0)
        prod = hvp(x)

        def hvp_free(v):
            return torch.where(free, prod(torch.where(free, v, 0.0)), 0.0)

        d, cg_used = _truncated_cg(hvp_free, g_free, opts.cg_iters, run_d)
        descent, cg_used = _host(_dot(g, d), cg_used)
        bad_dir = (descent >= 0) | ~torch.isfinite(descent) | use_sd
        d = torch.where(bad_dir.to(device)[:, None], -1.0 * g_free, d)

        # line search from a unit Newton step
        a_init = torch.ones_like(f)
        if bounded:
            x_new, f_new, g_new, ls_nfev, ls_ok = \
                _projected_backtracking_ls(value_and_grad, x, d, f, g,
                                           a_init, lo, hi, ls_opts, run)
        else:
            dphi0 = _host(_dot(g, d))[0]
            a, f_new, g_new, ls_nfev, ls_ok = _wolfe_line_search(
                value_and_grad, x, d, f, g, dphi0, a_init, big, ls_opts,
                run)
            x_new = _step(x, a, d)

        pgn = _host(_pgnorm(x_new, g_new, lo, hi))[0]
        df = f - f_new
        fden = torch.clamp_min(torch.maximum(torch.abs(f),
                                             torch.abs(f_new)), 1.0)
        conv_g = pgn <= opts.pgtol
        # an ftol-sized decrease on a steepest-descent retry is still
        # convergence; on a Newton step it may mean a loose CG solve
        conv_f = ls_ok & (df <= opts.ftol * fden)
        # a failed search on a Newton direction retries once from
        # steepest descent before the solve is declared failed
        fail = ~ls_ok & bad_dir
        retry = ~ls_ok & ~bad_dir
        new_status = torch.where(
            conv_g, CONV_GRAD,
            torch.where(fail, LS_FAIL,
                        torch.where(conv_f, CONV_FTOL, MAXITER))).to(
            torch.int32)
        take = run & ls_ok
        take_d = take.to(device)[:, None]
        x = torch.where(take_d, x_new, x)
        g = torch.where(take_d, g_new, g)
        f = torch.where(take, f_new, f)
        use_sd = torch.where(run, retry, use_sd)
        niter = niter + run.to(torch.int32)
        nfev = nfev + torch.where(run, ls_nfev + cg_used, 0)
        status = torch.where(run, new_status, status)
        done = torch.where(run, conv_g | conv_f | fail, done)

    res = LBFGSResult(x=x, f=f.to(device), g=g, niter=niter.to(device),
                      nfev=nfev.to(device), status=status.to(device),
                      pgnorm=_pgnorm(x, g, lo, hi))
    return LBFGSResult(*(t[0] for t in res)) if one else res
