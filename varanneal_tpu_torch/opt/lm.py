"""Matrix-free Levenberg–Marquardt / Gauss–Newton, batched over members.

Counterpart of ``varanneal_tpu/opt/lm.py`` (``LMOptions``, ``_cg``,
``lm_minimize``, ``make_residual_fn``). The problem is a residual
function ``r(z) -> (B, n_res)`` with A(z) = ‖r(z)‖² per row, weights and
normalizations folded in. The Jacobian is never formed: each CG step's
(JᵀJ + λI) v is one ``torch.func.jvp`` and one vector-Jacobian product
at the iterate (the vjp built once an iteration). The damped step comes
from a fixed ``cg_iters`` CG iterations, λ follows the gain ratio, and
the stopping rules are the L-BFGS solver's: pgtol on the max-norm of the
projected gradient, ftol on the relative decrease, maxiter, and a
failure (status 3) when λ reaches ``lam_max`` without a decrease. Box
bounds project the trial point.

The members are the rows of (B, n) tensors; a member whose loop has
ended is frozen. Everything but the loop's flags stays on the device:
the CG iterations read nothing back, and an iteration reads the members'
status once.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.ops.action import device_spec, unpack
from varanneal_tpu_torch.ops.disc import model_residuals
from varanneal_tpu_torch.opt.lbfgs import (
    CONV_FTOL, CONV_GRAD, LS_FAIL, MAXITER, LBFGSResult, _bounds, _dot,
    _host, _pgnorm)


@dataclasses.dataclass(frozen=True)
class LMOptions:
    maxiter: int = 100
    cg_iters: int = 20
    lam0: float = 1e-3
    lam_min: float = 1e-12
    lam_max: float = 1e12
    ftol: float = 2.220446049250313e-09
    pgtol: float = 1e-5


def _cg(matvec, b, iters):
    """Fixed-iteration CG for the SPD ``matvec`` on every row of ``b``;
    returns the approximate solve. No value leaves the device."""
    tiny = torch.tensor(1e-300, dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r, p = b, b
    rs = _dot(r, r)
    for _ in range(iters):
        Ap = matvec(p)
        denom = _dot(p, Ap)
        alpha = torch.where(denom > 0, rs / torch.maximum(denom, tiny), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = _dot(r, r)
        beta = rs_new / torch.maximum(rs, tiny)
        p = r + beta[:, None] * p
        rs = rs_new
    return x


def lm_minimize(residual_fn, x0, *, lower=None, upper=None,
                opts: Optional[LMOptions] = None,
                device=None) -> LBFGSResult:
    """Minimize ‖residual_fn(x)‖² for each row of ``x0`` ((B, n), or (n,)
    for one member); ``residual_fn`` maps (B, n) to (B, n_res), row by
    row. ``lower``/``upper``: flat (n,) or (B, n) bounds, ±inf for a free
    side. ``device=None`` means the CUDA card."""
    opts = opts or LMOptions()
    device = resolve_device(device)
    x = torch.as_tensor(x0).to(device)
    one = x.ndim == 1
    if one:
        x = x[None]
    B = x.shape[0]
    big = torch.finfo(x.dtype).max
    lo, hi = _bounds(lower, -big, x), _bounds(upper, big, x)

    def grad_at(z, r):
        return 2.0 * torch.func.vjp(residual_fn, z)[1](r)[0]

    x = torch.clamp(x, lo, hi)
    r = residual_fn(x)
    A = _dot(r, r)
    g = grad_at(x, r)
    lam = torch.full((B,), opts.lam0, dtype=x.dtype, device=device)
    pg0 = _host(_pgnorm(x, g, lo, hi))[0]
    niter = torch.zeros(B, dtype=torch.int32)
    nfev = torch.ones(B, dtype=torch.int32)
    done = pg0 <= opts.pgtol
    status = torch.where(done, CONV_GRAD, MAXITER).to(torch.int32)

    while True:
        run = ~done & (niter < opts.maxiter)
        if not bool(run.any()):
            break
        _, vjp_x = torch.func.vjp(residual_fn, x)
        lam_c = lam[:, None]

        def matvec(v):
            Jv = torch.func.jvp(residual_fn, (x,), (v,))[1]
            return vjp_x(Jv)[0] + lam_c * v

        delta = _cg(matvec, -0.5 * g, opts.cg_iters)
        x_t = torch.clamp(x + delta, lo, hi)
        r_t = residual_fn(x_t)
        A_t = _dot(r_t, r_t)

        # gain ratio: actual against model reduction, λ‖δ‖² − δᵀg/2
        pred = _dot(delta, lam_c * delta - 0.5 * g)
        rho = (A - A_t) / torch.clamp_min(pred, 1e-300)
        good = (A_t < A) & torch.isfinite(A_t)
        lam_n = torch.where(
            good & (rho > 0.75), torch.clamp_min(lam / 3.0, opts.lam_min),
            torch.where(good, lam,
                        torch.clamp_max(lam * 4.0, opts.lam_max)))
        gk = good[:, None]
        x_n = torch.where(gk, x_t, x)
        r_n = torch.where(gk, r_t, r)
        A_n = torch.where(good, A_t, A)
        g_n = torch.where(gk, grad_at(x_n, r_n), g)

        df = A - A_n
        fden = torch.clamp_min(torch.maximum(torch.abs(A), torch.abs(A_n)),
                               1.0)
        conv_g = _pgnorm(x_n, g_n, lo, hi) <= opts.pgtol
        conv_f = good & (df <= opts.ftol * fden)
        stuck = ~good & (lam >= opts.lam_max)
        new_status = torch.where(
            conv_g, CONV_GRAD,
            torch.where(stuck, LS_FAIL,
                        torch.where(conv_f, CONV_FTOL, MAXITER))).to(
            torch.int32)
        new_status, ended = _host(new_status,
                                  (conv_g | conv_f | stuck).to(torch.int32))
        run_d = run.to(device)
        rk = run_d[:, None]
        x = torch.where(rk, x_n, x)
        r = torch.where(rk, r_n, r)
        g = torch.where(rk, g_n, g)
        A = torch.where(run_d, A_n, A)
        lam = torch.where(run_d, lam_n, lam)
        niter = niter + run.to(torch.int32)
        nfev = nfev + torch.where(run, 2 + opts.cg_iters, 0).to(torch.int32)
        status = torch.where(run, new_status, status)
        done = torch.where(run, ended.bool(), done)

    res = LBFGSResult(x=x, f=A, g=g, niter=niter.to(device),
                      nfev=nfev.to(device), status=status.to(device),
                      pgnorm=_pgnorm(x, g, lo, hi))
    return LBFGSResult(*(t[0] for t in res)) if one else res


def make_residual_fn(spec, device=None):
    """Weighted residual ``residual(XP, rf) -> (..., n_res)`` of a
    ProblemSpec for a batched ``XP`` (..., n_dof): ‖residual(XP, rf)‖²
    equals the Gaussian action (``ops.action.make_action``). The whole R
    zoo is folded in: scalar, (N, K) diagonal and (N, K, K) matrix
    precision, a matrix R through its Cholesky factor (d·R·d = ‖Cᵀd‖²
    with R = C Cᵀ, so R must be SPD): RM's factored once on the host, an
    (N_f-1, D, D) rf's on the device at each call. ``device=None`` means
    the CUDA card."""
    device = resolve_device(device)
    RM = np.asarray(spec.RM, dtype=np.float64)
    norm_me = spec.L * spec.N_data
    me_w = (np.linalg.cholesky(RM / norm_me) if RM.ndim == 3
            else np.sqrt(RM / norm_me))
    norm_fe = spec.D * (spec.N_f - 1)
    cols = list(spec.Lidx)
    cache = {}

    def consts(dtype):
        if dtype not in cache:
            cache[dtype] = (device_spec(spec, device, dtype),
                            torch.as_tensor(me_w, device=device).to(dtype))
        return cache[dtype]

    def rows(C, d):
        """(Cᵀ d)_nl = Σ_k C[n, k, l] d[n, k]: per-row whitening."""
        return torch.einsum("nkl,...nk->...nl", C, d)

    def flat(a):
        return a.reshape(a.shape[:-2] + (-1,))

    def residual(XP, rf):
        if XP.device != device:
            raise ValueError(f"XP is on {XP.device}, the residual on "
                             f"{device}")
        sp, w = consts(XP.dtype)
        X, P = unpack(sp, XP)
        x_obs = X[..., :: spec.obs_stride, :][..., : spec.N_data, cols]
        diff = x_obs - sp.Y
        r_me = flat(rows(w, diff) if RM.ndim == 3 else w * diff)
        rf = torch.as_tensor(rf, dtype=XP.dtype).to(device)
        if rf.ndim == 3:
            fe_w = torch.linalg.cholesky(rf / norm_fe)
        else:
            fe_w = torch.sqrt(rf / norm_fe)

        def weigh(w_rows, res):
            if rf.ndim == 3:
                return flat(rows(w_rows, res))
            return flat(w_rows * res)

        res = model_residuals(sp, X, P)
        if spec.disc == "SimpsonHermite":
            simpson, hermite = res
            M = (spec.N_f - 1) // 2
            if rf.ndim == 0:
                ws = wh = fe_w
            else:
                ws, wh = fe_w[: 2 * M: 2], fe_w[1: 2 * M: 2]
            r_fe = torch.cat([weigh(ws, simpson), weigh(wh, hermite)],
                             dim=-1)
        else:
            r_fe = weigh(fe_w, res)
        return torch.cat([r_me, r_fe], dim=-1)

    return residual
