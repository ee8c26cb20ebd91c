"""L-BFGS-B with the generalized Cauchy point and subspace minimization,
batched over members.

Counterpart of ``varanneal_tpu/opt/lbfgsb.py`` (``_BState``,
``_proj_grad_norm``, ``_compact_matrices``, ``_cauchy_point``,
``_dense_solve``, ``_dense_inv``, ``_subspace_step``,
``lbfgsb_minimize``): the Byrd–Lu–Nocedal–Zhu algorithm that SciPy's
Fortran L-BFGS-B runs. Each iteration (1) finds the generalized Cauchy
point (GCP) along the projected steepest-descent path P(x − t g), (2)
minimizes the quadratic model over the variables still free there (the
direct primal method, projected onto the box), and (3) runs the
strong-Wolfe line search toward that point, capped at the box.

Step (1) is the reference's closed form: along the path the model's slope
on segment j is linear, m'(t) = f1_j + t·f2_j, with

    f1_j = −q_j − c_jᵀ M a_j,      f2_j = θ q_j − c_jᵀ M c_j,

where q_j (Σ g² over the still-moving variables), c_j (Σ g_i W_i over
them) and a_j (Σ t_i g_i W_i over the variables already fixed) are prefix
and suffix sums over the breakpoint-sorted coordinates: one stable sort,
two cumulative sums and (2m)-wide products for all segments at once. The
first segment whose slope turns nonnegative, or whose interior minimizer
lies inside it, gives the GCP. Step (2) uses the compact form
B = θI − W M Wᵀ (W = [Y, θS], M⁻¹ = [[−D, Lᵀ], [L, θ SᵀS]]) and
Sherman–Morrison–Woodbury on the free subspace; its small 2m × 2m systems
are solved by the reference's Gauss–Jordan elimination with partial
pivoting, so that the two packages take the same pivots.

The members are the rows of (B, n) tensors with a per-member done mask, as
in ``opt/lbfgs.py``: a finished member is frozen and its records no longer
change. The per-member scalars live on the host. The JAX package has no
kernel for this solver either; it is plain PyTorch on every device.
"""

from typing import NamedTuple, Optional

import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.opt.lbfgs import (
    CONV_GRAD, MAXITER, LBFGSOptions, LBFGSResult, _bounds, _dot,
    _end_iteration, _host, _step, _wolfe_line_search)


class _BState(NamedTuple):
    """The loop's state: vectors (B, n) and histories (B, m, n) on the
    device; head, hlen, niter, nfev, status and done (B,) on the host."""
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    S: torch.Tensor          # (B, m, n) step history
    Yh: torch.Tensor         # (B, m, n) gradient-difference history
    head: torch.Tensor
    hlen: torch.Tensor
    niter: torch.Tensor
    nfev: torch.Tensor
    status: torch.Tensor
    done: torch.Tensor


def _proj_grad_norm(x, g, lo, hi):
    return torch.amax(torch.abs(x - torch.clamp(x - g, lo, hi)), dim=-1)


def _mv(A, v):
    """Batched matrix-vector product: A (B, r, c), v (B, c) -> (B, r)."""
    return (A @ v[:, :, None])[:, :, 0]


def _compact_matrices(S, Yh, head, hlen, m, dtype):
    """θ (B,), Wt (B, 2m, n) and M⁻¹ (B, 2m, 2m) of the compact direct
    Hessian B = θI − W M Wᵀ, each member's history read oldest to newest
    from its circular buffer; invalid slots contribute exactly zero (W's
    columns zeroed, M⁻¹ the identity there)."""
    Bm, _, n = S.shape
    j = torch.arange(m, device=S.device)
    ord_ = (head[:, None] - m + j[None, :]) % m          # oldest..newest
    valid = j[None, :] >= (m - hlen[:, None])
    vf = valid.to(dtype)
    idx = ord_[:, :, None].expand(Bm, m, n)
    S_o = S.gather(1, idx) * vf[:, :, None]
    Y_o = Yh.gather(1, idx) * vf[:, :, None]

    SY = S_o @ Y_o.transpose(1, 2)                       # s_i . y_j
    SS = S_o @ S_o.transpose(1, 2)
    Dg = torch.diagonal(SY, dim1=1, dim2=2)
    sy_new = SY[:, m - 1, m - 1]
    yy_new = torch.sum(Y_o[:, m - 1] * Y_o[:, m - 1], dim=-1)
    theta = torch.where(hlen > 0, yy_new / torch.clamp_min(sy_new, 1e-300),
                        torch.ones_like(sy_new))

    Lm = torch.tril(SY, diagonal=-1)                     # s_i . y_j, i > j
    pad = torch.diag_embed((~valid).to(dtype))
    Minv = torch.cat([
        torch.cat([-torch.diag_embed(Dg) + pad, Lm.transpose(1, 2)], dim=2),
        torch.cat([Lm, theta[:, None, None] * SS + pad], dim=2)], dim=1)
    Wt = torch.cat([Y_o, theta[:, None, None] * S_o], dim=1)
    return theta, Wt, Minv


def _cauchy_point(x, g, lo, hi, theta, Wt, Minv, dtype):
    """Generalized Cauchy point along P(x − t g), all breakpoint segments
    at once (see the module docstring). Returns (x_cp, free), free being
    the variables still moving at the GCP."""
    Bm, n = x.shape
    two_m = Wt.shape[1]
    BIGT = 1e30

    t_i = torch.where(g > 0, (x - lo) / g,
                      torch.where(g < 0, (x - hi) / g,
                                  torch.full_like(x, BIGT)))
    t_i = torch.where(torch.isfinite(t_i), torch.clamp_max(t_i, BIGT),
                      torch.full_like(x, BIGT))
    t_i = torch.clamp_min(t_i, 0.0)

    order = torch.argsort(t_i, dim=1, stable=True)
    ts = t_i.gather(1, order)                            # ascending
    g_s = g.gather(1, order)
    Wg = (Wt.transpose(1, 2).gather(1, order[:, :, None].expand(
        Bm, n, two_m)) * g_s[:, :, None])                # rows g_i W_i

    g2 = g_s * g_s
    # prefix sums EXCLUSIVE of entry j (the first j sorted variables are
    # fixed inside segment j)
    z1 = torch.zeros(Bm, 1, dtype=dtype, device=x.device)
    zw = torch.zeros(Bm, 1, two_m, dtype=dtype, device=x.device)
    csum = torch.cat([z1, torch.cumsum(g2, dim=1)], dim=1)
    q = torch.sum(g2, dim=1, keepdim=True) - csum[:, :-1]
    cW = torch.cat([zw, torch.cumsum(Wg, dim=1)], dim=1)
    c = torch.sum(Wg, dim=1, keepdim=True) - cW[:, :-1]
    a = torch.cat([zw, torch.cumsum(Wg * ts[:, :, None], dim=1)],
                  dim=1)[:, :-1]

    Mc = c @ _dense_inv(Minv)
    f1 = -q - torch.sum(Mc * a, dim=2)                   # cᵀ M a
    f2 = theta[:, None] * q - torch.sum(Mc * c, dim=2)
    f2 = torch.clamp_min(f2, 1e-30)                      # B is PD; guard 0

    start = torch.cat([z1, ts[:, :-1]], dim=1)
    end = ts
    slope_at_start = f1 + start * f2
    t_star = -f1 / f2
    hit_start = slope_at_start >= 0
    hit_inside = ~hit_start & (t_star <= end)
    valid = hit_start | hit_inside
    cand = torch.where(hit_start, start, t_star)

    any_valid = valid.any(dim=1)
    j_star = torch.argmax(valid.to(torch.int32), dim=1)  # first True
    t_max = torch.amax(torch.where(ts >= BIGT, torch.zeros_like(ts), ts),
                       dim=1)
    t_cp = torch.where(any_valid, cand.gather(1, j_star[:, None])[:, 0],
                       t_max)
    t_cp = torch.clamp_min(t_cp, 0.0)

    x_cp = torch.clamp(x - t_cp[:, None] * g, lo, hi)
    free = t_i > t_cp[:, None]
    return x_cp, free


def _dense_solve(A, b):
    """Solve the small systems A x = b, A (B, k, k), by Gauss–Jordan
    elimination with partial pivoting, the reference's sequence of
    operations (it avoids XLA's LU on the TPU; here it keeps the two
    packages' pivots and round-off alike). ``b``: (B, k) or (B, k, r)."""
    Bm, k = A.shape[0], A.shape[-1]
    vec = b.ndim == 2
    Ab = torch.cat([A, b[:, :, None] if vec else b], dim=2)
    idx = torch.arange(k, device=A.device)
    rows = torch.arange(Bm, device=A.device)
    for kk in range(k):
        col = Ab[:, :, kk]
        mag = torch.where(idx >= kk, torch.abs(col),
                          torch.full_like(col, -1.0))
        p = torch.argmax(mag, dim=1)
        # swap rows kk and p (row kk takes row p, then row p row kk)
        perm = idx.expand(Bm, k).clone()
        perm[rows, p] = kk
        perm[:, kk] = p
        Ab = Ab.gather(1, perm[:, :, None].expand_as(Ab))
        piv = Ab[:, kk, kk]
        denom = torch.where(piv == 0, torch.ones_like(piv), piv)
        row_k = Ab[:, kk] / denom[:, None]
        Ab = torch.where((idx == kk)[None, :, None], row_k[:, None, :], Ab)
        factors = torch.where(idx[None, :] == kk,
                              torch.zeros_like(Ab[:, :, kk]), Ab[:, :, kk])
        Ab = Ab - factors[:, :, None] * row_k[:, None, :]
    out = Ab[:, :, k:]
    return out[:, :, 0] if vec else out


def _dense_inv(A):
    """Small dense inverses (B, k, k) by :func:`_dense_solve` on the
    identity."""
    k = A.shape[-1]
    eye = torch.eye(k, dtype=A.dtype, device=A.device).expand_as(A)
    return _dense_solve(A, eye)


def _subspace_step(x, g, x_cp, free, lo, hi, theta, Wt, Minv, dtype):
    """Direct primal subspace minimization (BLNZ §5.1) from the GCP over
    the free variables, by SMW on B_FF = θI − Ŵ M Ŵᵀ, the minimizer
    projected onto the box per coordinate (Morales–Nocedal 2011, the
    version SciPy ships). Returns the target point x_bar."""
    fm = free.to(dtype)
    u_cp = x_cp - x
    # r = ∇m(x_cp) = g + B u_cp, restricted to the free variables
    Wu = _mv(Wt, u_cp)
    Bu = theta[:, None] * u_cp - _mv(Wt.transpose(1, 2),
                                     _dense_solve(Minv, Wu))
    r = (g + Bu) * fm

    Wf = Wt * fm[:, None, :]                             # Ŵᵀ, masked
    Wr = _mv(Wf, r)
    G2 = Wf @ Wf.transpose(1, 2)
    # (θ I − Ŵ M Ŵᵀ)⁻¹ = (1/θ)I + (1/θ²) Ŵ (M⁻¹ − (1/θ)ŴᵀŴ)⁻¹ Ŵᵀ
    K = Minv - G2 / theta[:, None, None]
    inner = _dense_solve(K, Wr)
    d = -(r / theta[:, None]
          + _mv(Wf.transpose(1, 2), inner) / (theta * theta)[:, None])
    d = d * fm
    return torch.clamp(x_cp + d, lo, hi)


def lbfgsb_minimize(value_and_grad, x0, *, lower, upper,
                    opts: Optional[LBFGSOptions] = None,
                    device=None) -> LBFGSResult:
    """Bound-constrained L-BFGS with the GCP and subspace minimization, on
    each row of ``x0`` ((B, n), or (n,) for one member) subject to
    ``lower <= x <= upper`` (flat (n,) or (B, n), None or ±inf for a free
    side). ``value_and_grad(x) -> (f (B,), g (B, n))``; f may be float64
    while x is float32 (see ``opt/lbfgs.py``). The result contract is
    ``lbfgs_minimize``'s. ``device=None`` means the CUDA card."""
    opts = opts or LBFGSOptions()
    device = resolve_device(device)
    x = torch.as_tensor(x0).to(device)
    one = x.ndim == 1
    if one:
        x = x[None]
    if x.ndim != 2:
        raise ValueError("lbfgsb_minimize takes x0 of shape (n,) or (B, n)")
    dtype = x.dtype
    B, n = x.shape
    m = opts.m
    big = torch.finfo(dtype).max
    lo = torch.broadcast_to(_bounds(lower, -big, x), (B, n))
    hi = torch.broadcast_to(_bounds(upper, big, x), (B, n))
    rows = torch.arange(B, device=device)

    x = torch.clamp(x, lo, hi)
    f_dev, g = value_and_grad(x)
    f, pg0 = _host(f_dev, _proj_grad_norm(x, g, lo, hi))
    done = pg0 <= opts.pgtol
    s = _BState(
        x=x, f=f, g=g,
        S=torch.zeros(B, m, n, dtype=dtype, device=device),
        Yh=torch.zeros(B, m, n, dtype=dtype, device=device),
        head=torch.zeros(B, dtype=torch.long),
        hlen=torch.zeros(B, dtype=torch.long),
        niter=torch.zeros(B, dtype=torch.int32),
        nfev=torch.ones(B, dtype=torch.int32),
        status=torch.where(done, CONV_GRAD, MAXITER).to(torch.int32),
        done=done)

    while True:
        run = ~s.done & (s.niter < opts.maxiter)
        if not bool(run.any()):
            break
        head_d, hlen_d = torch.stack([s.head, s.hlen]).to(device)
        theta, Wt, Minv = _compact_matrices(s.S, s.Yh, head_d, hlen_d, m,
                                            dtype)
        x_cp, free = _cauchy_point(s.x, s.g, lo, hi, theta, Wt, Minv,
                                   dtype)
        x_bar = torch.clamp(_subspace_step(s.x, s.g, x_cp, free, lo, hi,
                                           theta, Wt, Minv, dtype), lo, hi)
        d = x_bar - s.x

        # fall back to the GCP direction, then projected steepest descent
        descent = _dot(s.g, d)
        use_cp = (descent >= 0) | ~torch.isfinite(descent)
        d = torch.where(use_cp[:, None], x_cp - s.x, d)
        descent = _dot(s.g, d)
        use_sd = (descent >= 0) | ~torch.isfinite(descent)
        d = torch.where(use_sd[:, None], torch.clamp(s.x - s.g, lo, hi) - s.x,
                        d)

        # strong Wolfe along d: a = 1 reaches the subspace minimizer, and
        # the search may extend to the box-feasibility limit along d
        # (dcsrch's stpmax; Armijo alone accepts at the cap)
        inf = torch.full_like(d, float("inf"))
        amax_i = torch.where(d > 0, (hi - s.x) / d,
                             torch.where(d < 0, (lo - s.x) / d, inf))
        a_max = torch.amin(torch.where(torch.isfinite(amax_i), amax_i, inf),
                           dim=1)
        a_max = torch.clamp(torch.where(torch.isfinite(a_max), a_max,
                                        torch.ones_like(a_max)), 1.0, 1e10)
        dphi0, a_max = _host(_dot(s.g, d), a_max)
        a, f_new, g_new, ls_nfev, ls_ok = _wolfe_line_search(
            value_and_grad, s.x, d, s.f, s.g, dphi0,
            torch.ones(B, dtype=dtype), a_max, opts, run)
        x_new = torch.clamp(_step(s.x, a, d), lo, hi)

        # history update (skip on tiny curvature)
        sv = x_new - s.x
        yv = g_new - s.g
        sy, ss, yy, pgn = _host(_dot(sv, yv), _dot(sv, sv), _dot(yv, yv),
                                _proj_grad_norm(x_new, g_new, lo, hi))
        good = (run & ls_ok & (sy > 1e-10 * torch.sqrt(ss) * torch.sqrt(yy))
                & (sy > 0))
        gk = good.to(device)[:, None]
        S, Yh = s.S, s.Yh
        S[rows, head_d] = torch.where(gk, sv, S[rows, head_d])
        Yh[rows, head_d] = torch.where(gk, yv, Yh[rows, head_d])
        head = torch.where(good, (s.head + 1) % m, s.head)
        hlen = torch.where(good, torch.clamp_max(s.hlen + 1, m), s.hlen)

        x, g, f, niter, nfev, status, done = _end_iteration(
            opts, run, ls_ok, ls_nfev, pgn, s.x, x_new, s.g, g_new, s.f,
            f_new, s.niter, s.nfev, s.status, s.done)
        s = _BState(x=x, f=f, g=g, S=S, Yh=Yh, head=head, hlen=hlen,
                    niter=niter, nfev=nfev, status=status, done=done)

    res = LBFGSResult(x=s.x, f=s.f.to(device), g=s.g,
                      niter=s.niter.to(device), nfev=s.nfev.to(device),
                      status=s.status.to(device),
                      pgnorm=_proj_grad_norm(s.x, s.g, lo, hi))
    if one:
        res = LBFGSResult(*(t[0] for t in res))
    return res
