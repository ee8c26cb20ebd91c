"""Batched L-BFGS in PyTorch, one member per row, with box bounds.

Counterpart of ``varanneal_tpu/opt/lbfgs.py`` (``LBFGSOptions``,
``LBFGSResult``, ``_project``, ``_proj_grad``, ``_cubic_min``,
``_wolfe_line_search``, ``_projected_backtracking_ls``, ``_two_loop``,
``_compact_dir``, ``_lbfgs_fused_loop``, ``lbfgs_minimize``): the
unbounded loop, the bounded ``projection`` algorithm and the fused loop.

The JAX solver ``vmap``s a ``lax.while_loop`` over ensemble members. Here
the members are the rows of ``(B, n)`` tensors and every loop carries a
per-member mask: a member whose loop has ended is frozen (its ``x``, ``f``,
``g``, ``niter``, ``nfev`` and ``status`` no longer change), and each
member's line search runs its own bracket and zoom in lockstep with the
others, as the vmapped nested ``while_loop`` does. Every evaluation calls
``value_and_grad`` on all B rows; rows whose loop has ended are computed
and ignored. So per member the iterates, ``niter``, ``nfev`` and
``status`` are those of the JAX solver.

Statuses: 0 pgtol-converged, 1 ftol-converged, 2 maxiter, 3 line-search
failure or NaN.

Bounds (``lower``/``upper``, ±inf for a free side) run the projection
algorithm (``bounded_algo='auto'`` resolves to it, as in the JAX
package): a feasible start, components at a bound with the gradient
pushing out frozen out of the direction, Armijo backtracking along the
projected path P(x + a d), and pgtol on SciPy's projected gradient
x - P(x - g). ``bounded_algo='subspace'`` with bounds runs the subspace
L-BFGS-B (generalized Cauchy point and subspace minimization,
``opt/lbfgsb.py``).

``direction='auto'`` resolves to ``'compact_pallas'`` where
``kernels.dir.dir_supported`` holds (f32 on the card, the reference's
envelope), else to ``'compact'``, as the JAX solver does off the TPU.
``'compact_pallas'`` runs the direction kernel K7a in the bounded loop
and, unbounded, the fused loop: one launch of the step kernel K7b per
iteration (history write, curvature gate, norms and next direction). An
explicit ``'compact_pallas'`` on CPU tensors runs the kernels' plain
versions, outside that envelope ``'compact'``.

The vectors (x, g, directions, history) live on the device; the
per-member scalars and flags of both loops live on the host, so each
line-search step costs one device-to-host transfer and a handful of
launches rather than a launch per scalar update. History buffers are
updated in place where the mask allows; the caller's ``x0`` is never
written.

The objective's values may be float64 while x is float32 (a compensated
f32 action, ``ops.action.combine_dtype``). Then, as in the JAX solver, f
and the line searches' step lengths and Armijo/Wolfe comparisons are kept
in f's dtype, the directional derivatives are cast up to it, and every
update of x casts the step back to x's dtype (the JAX package's
``_axpy``): the action is never evaluated on a float64 x.
"""

import dataclasses
from typing import NamedTuple, Optional

import torch

from varanneal_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class LBFGSOptions:
    """Solver options (defaults mirror SciPy L-BFGS-B's)."""
    m: int = 10                 # history size (scipy maxcor)
    maxiter: int = 1000
    ftol: float = 2.220446049250313e-09   # scipy default factr=1e7 -> 1e7*eps
    pgtol: float = 1e-5
    maxls: int = 30
    c1: float = 1e-4            # Armijo constant
    c2: float = 0.9             # curvature constant
    # 'auto' (-> 'compact_pallas' where kernels.dir.dir_supported holds,
    # else 'compact'), 'compact' (Byrd–Nocedal–Schnabel compact form),
    # 'two_loop' (classic recursion) or 'compact_pallas' (K7a/K7b)
    direction: str = "auto"
    # bound handling: 'auto' (-> 'projection'), 'projection' (active-set
    # freeze + projected-path Armijo), 'subspace' (GCP + subspace
    # minimization, opt/lbfgsb.py)
    bounded_algo: str = "auto"


class LBFGSResult(NamedTuple):
    x: torch.Tensor         # (B, n)
    f: torch.Tensor         # (B,)
    g: torch.Tensor         # (B, n)
    niter: torch.Tensor     # (B,) int32
    nfev: torch.Tensor      # (B,) int32
    status: torch.Tensor    # (B,) int32: 0 pgtol-converged, 1 ftol-
    #                         converged, 2 maxiter, 3 line-search failure
    pgnorm: torch.Tensor    # (B,)


# status codes
CONV_GRAD, CONV_FTOL, MAXITER, LS_FAIL = 0, 1, 2, 3


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cubic_min(a, fa, dfa, b, fb, dfb):
    """Minimizer of the cubic Hermite interpolant on [a, b]; NaN-safe fall
    back to bisection."""
    d1 = dfa + dfb - 3.0 * (fa - fb) / (a - b)
    arg = d1 * d1 - dfa * dfb
    d2 = torch.sqrt(torch.clamp_min(arg, 0.0)) * torch.sign(b - a)
    denom = dfb - dfa + 2.0 * d2
    t = b - (b - a) * (dfb + d2 - d1) / denom
    bad = (arg < 0.0) | ~torch.isfinite(t) | (denom == 0.0)
    return torch.where(bad, 0.5 * (a + b), t)


def _host(*vals):
    """Per-member (B,) device values, copied to the host in one transfer,
    each in its own dtype: values of mixed dtype (a float64 f beside
    float32 scalars) cross as float64 and are cast back, exactly."""
    dts = [v.dtype for v in vals]
    if len(set(dts)) == 1:
        return tuple(torch.stack(vals).cpu())
    wide = torch.stack([v.to(torch.float64) for v in vals]).cpu()
    return tuple(w.to(dt) for w, dt in zip(wide, dts))


def _step(x, a, d):
    """x + a d per row, the host step lengths ``a`` cast to x's dtype on
    its device (the JAX package's ``_axpy``)."""
    return x + a.to(device=x.device, dtype=x.dtype)[:, None] * d


def _wolfe_line_search(vag, x, d, f0, g0, dphi0, a_init, a_max, opts, run):
    """Strong-Wolfe line search along rows d from rows x, for the members
    where ``run`` holds. ``vag(x) -> (f, g)``. ``a_max``: the step cap, a
    float or one per member on the host. The per-member scalars
    (``f0``, ``dphi0``, ``a_init``, ``run`` and the state below) live on
    the host; ``x``, ``d``, ``g0`` on the device. The step lengths, slopes
    and comparisons are in f0's dtype, as the JAX line search keeps them.
    Returns (a_star, f_star, g_star, nfev, ok), one entry per member."""
    dev = x.device
    c1, c2 = opts.c1, opts.c2
    ft = f0.dtype
    dphi0 = dphi0.to(ft)
    if torch.is_tensor(a_max):
        a_max = a_max.to(ft)
    zero = torch.zeros_like(f0)
    s = dict(
        zoom=torch.zeros_like(run), done=torch.zeros_like(run),
        failed=torch.zeros_like(run),
        i=torch.zeros(run.shape, dtype=torch.int32),
        a=torch.clamp_max(a_init.to(ft), a_max),
        a_prev=zero, f_prev=f0, d_prev=dphi0,
        a_lo=zero, f_lo=f0, d_lo=dphi0,
        a_hi=zero, f_hi=f0, d_hi=dphi0,
        a_star=zero, f_star=f0)
    g_star = g0

    while True:
        act = run & ~(s["done"] | s["failed"]) & (s["i"] < opts.maxls)
        if not bool(act.any()):
            break
        a = s["a"]
        f_dev, g_a = vag(_step(x, a, d))
        f_a, dphi_a = _host(f_dev, _dot(g_a, d))
        dphi_a = dphi_a.to(ft)
        i = s["i"] + 1
        armijo_fail = f_a > f0 + c1 * a * dphi0
        nan_bad = ~torch.isfinite(f_a)
        curv_ok = torch.abs(dphi_a) <= -c2 * dphi0
        in_br = ~s["zoom"]

        # bracket stage (Nocedal-Wright alg. 3.5); at the step cap a_max
        # Armijo alone accepts (L-BFGS-B's dcsrch stpmax semantics)
        at_cap = a >= a_max
        hi_b = armijo_fail | ((i > 1) & (f_a >= s["f_prev"])) | nan_bad
        accept_b = ~hi_b & (curv_ok | at_cap)
        to_zoom_rev = ~hi_b & ~curv_ok & ~at_cap & (dphi_a >= 0)
        enter_zoom = hi_b | to_zoom_rev
        a_lo_b = torch.where(hi_b, s["a_prev"], a)
        f_lo_b = torch.where(hi_b, s["f_prev"], f_a)
        d_lo_b = torch.where(hi_b, s["d_prev"], dphi_a)
        a_hi_b = torch.where(hi_b, a, s["a_prev"])
        f_hi_b = torch.where(hi_b, f_a, s["f_prev"])
        d_hi_b = torch.where(hi_b, dphi_a, s["d_prev"])

        # zoom stage
        hi_z = armijo_fail | (f_a >= s["f_lo"]) | nan_bad
        accept_z = ~hi_z & curv_ok
        swap = ~hi_z & ~curv_ok & (dphi_a * (s["a_hi"] - s["a_lo"]) >= 0)
        a_hi_z = torch.where(hi_z, a, torch.where(swap, s["a_lo"],
                                                  s["a_hi"]))
        f_hi_z = torch.where(hi_z, f_a, torch.where(swap, s["f_lo"],
                                                    s["f_hi"]))
        d_hi_z = torch.where(hi_z, dphi_a, torch.where(swap, s["d_lo"],
                                                       s["d_hi"]))
        a_lo_z = torch.where(hi_z, s["a_lo"], a)
        f_lo_z = torch.where(hi_z, s["f_lo"], f_a)
        d_lo_z = torch.where(hi_z, s["d_lo"], dphi_a)

        # merged next state
        a_lo = torch.where(in_br, a_lo_b, a_lo_z)
        f_lo = torch.where(in_br, f_lo_b, f_lo_z)
        d_lo = torch.where(in_br, d_lo_b, d_lo_z)
        a_hi = torch.where(in_br, a_hi_b, a_hi_z)
        f_hi = torch.where(in_br, f_hi_b, f_hi_z)
        d_hi = torch.where(in_br, d_hi_b, d_hi_z)
        width = torch.abs(a_hi - a_lo)
        a_interp = _cubic_min(a_lo, f_lo, d_lo, a_hi, f_hi, d_hi)
        a_interp = torch.clamp(
            a_interp, torch.minimum(a_lo, a_hi) + 0.1 * width,
            torch.maximum(a_lo, a_hi) - 0.1 * width)
        a_expand = torch.clamp_max(2.0 * a, a_max)
        a_next = torch.where(in_br & ~enter_zoom, a_expand, a_interp)
        tiny = width <= 1e-14 * torch.clamp_min(torch.abs(a_lo), 1.0)
        accept = torch.where(in_br, accept_b, accept_z)
        failed = torch.where(in_br, nan_bad & (i >= opts.maxls),
                             tiny & ~accept)
        new = dict(
            zoom=~(in_br & ~enter_zoom), done=accept, failed=failed, i=i,
            a=a_next, a_prev=a,
            f_prev=torch.where(in_br, f_a, s["f_prev"]),
            d_prev=torch.where(in_br, dphi_a, s["d_prev"]),
            a_lo=a_lo, f_lo=f_lo, d_lo=d_lo,
            a_hi=a_hi, f_hi=f_hi, d_hi=d_hi,
            a_star=torch.where(accept, a, s["a_star"]),
            f_star=torch.where(accept, f_a, s["f_star"]))
        s = {k: torch.where(act, v, s[k]) for k, v in new.items()}
        g_star = torch.where((act & accept).to(dev)[:, None], g_a, g_star)

    # fallback: no Wolfe point, but the zoom bracket's lo end improves on
    # f0 (Armijo holds there by construction) — take it
    done = s["done"]
    have_lo = (s["a_lo"] > 0) & (s["f_lo"] < f0)
    ok = done | have_lo
    f_l, g_l = f0, g0
    if bool((run & ~done & have_lo).any()):
        f_dev, g_l = vag(_step(x, s["a_lo"], d))
        f_l = f_dev.cpu()
    a_star = torch.where(done, s["a_star"],
                         torch.where(have_lo, s["a_lo"], zero))
    f_star = torch.where(done, s["f_star"], torch.where(have_lo, f_l, f0))
    done_d, lo_d = torch.stack([done, have_lo]).to(dev)
    g_star = torch.where(done_d[:, None], g_star,
                         torch.where(lo_d[:, None], g_l, g0))
    nfev = s["i"] + (~done & have_lo).to(torch.int32)
    return a_star, f_star, g_star, nfev, ok


def _hist_rows(H, idx):
    """Rows ``idx[b]`` of each member's history ``H[b]``: (B, n)."""
    return H[torch.arange(H.shape[0], device=H.device), idx]


def _two_loop(g, H, rho, head, hlen, m):
    """Two-loop recursion over each member's circular history, newest to
    oldest. ``H`` is the joint (B, 2m, n) history: rows [0, m) hold the
    steps s_i, rows [m, 2m) the gradient differences y_i."""
    rows = torch.arange(g.shape[0], device=g.device)
    q = g
    alphas, idxs = [], []
    for j in range(m):
        i = (head - 1 - j) % m
        idxs.append(i)
        valid = (j < hlen).to(g.dtype)
        a = valid * rho[rows, i] * _dot(_hist_rows(H, i), q)
        q = q + (-a)[:, None] * _hist_rows(H, m + i)
        alphas.append(a)
    i0 = (head - 1) % m
    y0 = _hist_rows(H, m + i0)
    s0 = _hist_rows(H, i0)
    gamma = torch.where(hlen > 0,
                        _dot(s0, y0) / torch.clamp_min(_dot(y0, y0), 1e-300),
                        torch.ones_like(rho[:, 0]))
    r = gamma[:, None] * q
    for j in reversed(range(m)):
        i = idxs[j]
        valid = (j < hlen).to(g.dtype)
        b = valid * rho[rows, i] * _dot(_hist_rows(H, m + i), r)
        r = r + (alphas[j] - b)[:, None] * _hist_rows(H, i)
    return -1.0 * r


def _compact_dir(g, H, rho, head, hlen, m):
    """L-BFGS direction via the Byrd–Nocedal–Schnabel compact
    representation, numerically the same inverse-Hessian application as
    the two-loop recursion:

        Hinv = γI + [S γY] [[R^{-T}(D+γYᵀY)R^{-1}, -R^{-T}], [-R^{-1}, 0]]
                     [Sᵀ; γYᵀ],   R = triu(SᵀY), D = diag(SᵀY)

    ``H`` is the joint (B, 2m, n) history, so the Gram matrix, the history
    matvec and the closing contraction are one batched product each."""
    del rho
    B = g.shape[0]
    dtype = g.dtype
    j = torch.arange(m, device=g.device)
    # slot ord[b, j] holds member b's j-th oldest pair; the first m-hlen
    # are invalid
    ord_ = (head[:, None] - m + j[None, :]) % m
    valid = j[None, :] >= (m - hlen[:, None])
    vf = valid.to(dtype)

    G = H @ H.transpose(1, 2)                          # (B, 2m, 2m)
    r_idx = ord_[:, :, None].expand(B, m, m)
    c_idx = ord_[:, None, :].expand(B, m, m)
    SY = G[:, :m, m:].gather(1, r_idx).gather(2, c_idx)   # s_i . y_j
    YY = G[:, m:, m:].gather(1, r_idx).gather(2, c_idx)
    mask2 = vf[:, :, None] * vf[:, None, :]
    SY = SY * mask2
    YY = YY * mask2
    # unit diagonal on invalid slots keeps the triangular solves regular
    R = torch.triu(SY) + torch.diag_embed((~valid).to(dtype))
    Dd = torch.diag_embed(torch.diagonal(SY, dim1=1, dim2=2))

    sy_new = SY[:, m - 1, m - 1]
    yy_new = YY[:, m - 1, m - 1]
    gamma = torch.where(hlen > 0, sy_new / torch.clamp_min(yy_new, 1e-300),
                        torch.ones_like(sy_new))

    ab = (H @ g[:, :, None])[:, :, 0]                  # [Sᵀg; Yᵀg]
    a = ab[:, :m].gather(1, ord_) * vf
    b = ab[:, m:].gather(1, ord_) * vf

    u = torch.linalg.solve_triangular(R, a[:, :, None], upper=True)
    v = (Dd + gamma[:, None, None] * YY) @ u - gamma[:, None, None] * b[
        :, :, None]
    w = torch.linalg.solve_triangular(R.transpose(1, 2), v, upper=False)
    q1 = w[:, :, 0] * vf
    q2 = -u[:, :, 0] * vf

    # scatter back to raw slot order and contract with the joint history:
    # Hinv g = γg + S·q1 + γ(Y·q2) = γg + [q1; γq2]·H
    ord2 = torch.cat([ord_, m + ord_], dim=1)
    q_full = torch.zeros(B, 2 * m, dtype=dtype, device=g.device).scatter(
        1, ord2, torch.cat([q1, gamma[:, None] * q2], dim=1))
    Hq = (q_full[:, None, :] @ H)[:, 0]
    return -1.0 * (gamma[:, None] * g + Hq)


def _pgnorm(x, g, lo, hi):
    """Max-norm of SciPy's projected gradient x - P(x - g), P the clip to
    [lo, hi]. Without bounds P only clips at the dtype's largest value,
    but x - (x - g) still rounds; the JAX solver tests pgtol on exactly
    this, so the port does too and the two agree on every status."""
    return torch.amax(torch.abs(x - torch.clamp(x - g, lo, hi)), dim=-1)


def _frozen(x, g, lo, hi):
    """The active set of the projection algorithm: components at a bound
    (within 1e-12, added in the dtype) whose gradient pushes out of the
    box."""
    return (((x <= lo + 1e-12) & (g > 0))
            | ((x >= hi - 1e-12) & (g < 0)))


def _projected_backtracking_ls(vag, x, d, f0, g0, a_init, lo, hi, opts,
                               run):
    """Armijo backtracking along the projected path P(x + a d), for the
    members where ``run`` holds: sufficient decrease against
    g0·(P(x + a d) - x), the step halved until it holds or ``maxls``
    trials are spent. ``f0`` and ``a_init`` live on the host; the step
    and the test are in f0's dtype. Returns (x_new, f_new, g_new, nfev,
    ok); a member whose search fails keeps x, f0 and g0."""
    dev = x.device
    c1 = opts.c1
    ft = f0.dtype

    def trial(a):
        return torch.clamp(_step(x, a, d), lo, hi)

    def armijo(f_a, gdx):
        return (f_a <= f0 + c1 * gdx) & torch.isfinite(f_a) & (f_a < f0)

    a = a_init.to(ft, copy=True)
    i = torch.ones(run.shape, dtype=torch.int32)
    x_a = trial(a)
    f_dev, g_a = vag(x_a)
    f_a, gdx = _host(f_dev, _dot(g0, x_a - x))
    gdx = gdx.to(ft)
    while True:
        act = run & ~armijo(f_a, gdx) & (i < opts.maxls)
        if not bool(act.any()):
            break
        a = torch.where(act, 0.5 * a, a)
        x_n = trial(a)
        f_dev, g_n = vag(x_n)
        f_n, gdx_n = _host(f_dev, _dot(g0, x_n - x))
        gdx_n = gdx_n.to(ft)
        act_d = act.to(dev)[:, None]
        x_a = torch.where(act_d, x_n, x_a)
        g_a = torch.where(act_d, g_n, g_a)
        f_a = torch.where(act, f_n, f_a)
        gdx = torch.where(act, gdx_n, gdx)
        i = i + act.to(torch.int32)
    ok = armijo(f_a, gdx)
    ok_d = ok.to(dev)[:, None]
    return (torch.where(ok_d, x_a, x), torch.where(ok, f_a, f0),
            torch.where(ok_d, g_a, g0), i, ok)


def _resolve_direction(opts, x):
    """``opts.direction`` as this solve runs it (see the module
    docstring)."""
    from varanneal_tpu_torch.kernels import dir as kdir
    direction = opts.direction
    if direction == "auto":
        return ("compact_pallas" if kdir.dir_supported(x, opts.m)
                else "compact")
    if direction == "compact_pallas":
        return ("compact_pallas"
                if kdir.dir_predicate(x.shape[-1], opts.m, x.dtype)
                else "compact")
    if direction not in ("compact", "two_loop"):
        raise ValueError(f"unknown direction {opts.direction!r}")
    return direction


def _bounds(bound, fill, x):
    """A user bound (None, NumPy or tensor, broadcastable to x) as a
    tensor of x's dtype on its device; None becomes ``fill``."""
    if bound is None:
        return torch.full(x.shape[-1:], fill, dtype=x.dtype,
                          device=x.device)
    return torch.as_tensor(bound).to(device=x.device, dtype=x.dtype)


def _end_iteration(opts, run, ls_ok, ls_nfev, pgn, x, x_new, g, g_new, f,
                   f_new, niter, nfev, status, done):
    """The stopping rules and the lockstep freeze, shared by both loops:
    the status of each running member from its new gradient norm ``pgn``,
    its line search and its relative decrease; the new point taken where
    the line search held (the old one kept where it failed); ended members
    left as they were. Returns (x, g, f, niter, nfev, status, done)."""
    fail = ~ls_ok
    take = run & ~fail
    df = f - f_new
    fden = torch.clamp_min(torch.maximum(torch.abs(f), torch.abs(f_new)),
                           1.0)
    conv_g = pgn <= opts.pgtol
    conv_f = df <= opts.ftol * fden
    new_status = torch.where(
        conv_g, CONV_GRAD,
        torch.where(fail, LS_FAIL,
                    torch.where(conv_f, CONV_FTOL, MAXITER))).to(torch.int32)
    take_d = take.to(x.device)[:, None]
    return (torch.where(take_d, x_new, x), torch.where(take_d, g_new, g),
            torch.where(take, f_new, f), niter + run.to(torch.int32),
            nfev + torch.where(run, ls_nfev, 0),
            torch.where(run, new_status, status),
            torch.where(run, conv_g | conv_f | fail, done))


def _fused_loop(value_and_grad, x, opts):
    """Unbounded L-BFGS with one launch of the step kernel K7b
    (``kernels.dir.fused_step``) per iteration: the port of
    ``_lbfgs_fused_loop``. Where it differs from the generic loop, as the
    JAX fused loop does: x0 is not clamped to the dtype's range; the first
    direction is -g0; the curvature gate is ``sy > 1e-10·sqrt(s2·y2)``
    rather than ``sqrt(ss)·sqrt(yy)``; K7b's γ takes max(yᵀy, 1e-30), as
    the Pallas kernel does (its plain version keeps ``_compact_dir``'s
    1e-300); pgtol and the final pgnorm use max|g| rather than
    the projected gradient; and the next direction comes from the
    updated history at g_new with -g_new on non-descent. K7b also
    returns the next line search's g·d, so an iteration reads its scalars
    from the card in one copy after the line search."""
    from varanneal_tpu_torch.kernels import dir as kdir
    device = x.device
    dtype = x.dtype
    B, n = x.shape
    m = opts.m
    big = torch.finfo(dtype).max

    f_dev, g = value_and_grad(x)
    d = -1.0 * g
    f, pg0, gnorm1, dphi0 = _host(f_dev, torch.amax(torch.abs(g), dim=-1),
                                  torch.sum(torch.abs(g), dim=-1), _dot(g, d))
    H = torch.zeros(B, 2 * m, n, dtype=dtype, device=device)
    head = torch.zeros(B, dtype=torch.int32, device=device)
    hlen = torch.zeros(B, dtype=torch.int32, device=device)
    hlen_h = torch.zeros(B, dtype=torch.long)
    niter = torch.zeros(B, dtype=torch.int32)
    nfev = torch.ones(B, dtype=torch.int32)
    done = pg0 <= opts.pgtol
    status = torch.where(done, CONV_GRAD, MAXITER).to(torch.int32)

    while True:
        run = ~done & (niter < opts.maxiter)
        if not bool(run.any()):
            break
        a_init = torch.where(
            hlen_h == 0,
            torch.clamp_max(1.0 / torch.clamp_min(gnorm1, 1e-300), 1.0),
            torch.ones_like(gnorm1))
        a, f_new, g_new, ls_nfev, ls_ok = _wolfe_line_search(
            value_and_grad, x, d, f, g, dphi0, a_init, big, opts, run)
        x_new = _step(x, a, d)
        d_next, sc = kdir.fused_step(H, x, x_new, g, g_new, head, hlen,
                                     ls_ok, run)
        _, pgn, gn1, _, hl, _, dphi = sc.cpu().unbind(1)

        d = torch.where(run.to(device)[:, None], d_next, d)
        gnorm1 = torch.where(run, gn1, gnorm1)
        dphi0 = torch.where(run, dphi, dphi0)
        hlen_h = torch.where(run, hl.to(torch.long), hlen_h)
        x, g, f, niter, nfev, status, done = _end_iteration(
            opts, run, ls_ok, ls_nfev, pgn, x, x_new, g, g_new, f, f_new,
            niter, nfev, status, done)

    return LBFGSResult(x=x, f=f.to(device), g=g, niter=niter.to(device),
                       nfev=nfev.to(device), status=status.to(device),
                       pgnorm=torch.amax(torch.abs(g), dim=-1))


def lbfgs_minimize(value_and_grad, x0, *, lower=None, upper=None,
                   opts: Optional[LBFGSOptions] = None,
                   device=None) -> LBFGSResult:
    """Minimize each row of ``x0`` ((B, n), or (n,) for one member) given
    ``value_and_grad(x) -> (f (B,), g (B, n))``, optionally subject to
    ``lower <= x <= upper`` (flat (n,) or (B, n) bounds, ±inf for a free
    side). ``device=None`` means the CUDA card. See the module docstring
    for the semantics."""
    opts = opts or LBFGSOptions()
    algo = "projection" if opts.bounded_algo == "auto" else opts.bounded_algo
    if algo not in ("projection", "subspace"):
        raise ValueError(f"unknown bounded_algo {opts.bounded_algo!r}")
    bounded = lower is not None or upper is not None
    if bounded and algo == "subspace":
        from varanneal_tpu_torch.opt.lbfgsb import lbfgsb_minimize
        return lbfgsb_minimize(value_and_grad, x0, lower=lower,
                               upper=upper, opts=opts, device=device)
    device = resolve_device(device)

    x = torch.as_tensor(x0).to(device)
    one = x.ndim == 1
    if one:
        x = x[None]
    direction = _resolve_direction(opts, x)
    if direction == "compact_pallas" and not bounded:
        res = _fused_loop(value_and_grad, x, opts)
        return LBFGSResult(*(t[0] for t in res)) if one else res
    if direction == "compact_pallas":
        from varanneal_tpu_torch.kernels import dir as kdir

        def dir_fn(g, H, rho, head, hlen, m):
            return kdir.compact_dir(g, H, head, hlen)
    else:
        dir_fn = _compact_dir if direction == "compact" else _two_loop
    dtype = x.dtype
    B, n = x.shape
    m = opts.m
    big = torch.finfo(dtype).max
    rows = torch.arange(B, device=device)
    if bounded:
        lo, hi = _bounds(lower, -big, x), _bounds(upper, big, x)
    else:
        lo, hi = -big, big

    # vectors (x, g, d, history) stay on the device; the per-member
    # scalars and flags live on the host, where each of the solver's many
    # small updates costs far less than a device launch
    x = torch.clamp(x, lo, hi)
    f_dev, g = value_and_grad(x)
    f, pg0 = _host(f_dev, _pgnorm(x, g, lo, hi))
    H = torch.zeros(B, 2 * m, n, dtype=dtype, device=device)
    rho = torch.zeros(B, m, dtype=dtype, device=device)
    head = torch.zeros(B, dtype=torch.long)
    hlen = torch.zeros(B, dtype=torch.long)
    niter = torch.zeros(B, dtype=torch.int32)
    nfev = torch.ones(B, dtype=torch.int32)
    done = pg0 <= opts.pgtol
    status = torch.where(done, CONV_GRAD, MAXITER).to(torch.int32)

    while True:
        run = ~done & (niter < opts.maxiter)
        if not bool(run.any()):
            break
        head_d, hlen_d = torch.stack([head, hlen]).to(device)
        if bounded:
            # bound-active components frozen out of the direction
            act = _frozen(x, g, lo, hi)
            g_free = torch.where(act, 0.0, g)
            d = torch.where(act, 0.0, dir_fn(g_free, H, rho, head_d,
                                             hlen_d, m))
        else:
            g_free = g
            d = dir_fn(g, H, rho, head_d, hlen_d, m)
        descent = _dot(g, d)
        bad_dir = (descent >= 0) | ~torch.isfinite(descent)
        d = torch.where(bad_dir[:, None], -1.0 * g_free, d)

        gnorm1, dphi0 = _host(torch.sum(torch.abs(g), dim=-1), _dot(g, d))
        a_init = torch.where(
            hlen == 0,
            torch.clamp_max(1.0 / torch.clamp_min(gnorm1, 1e-300), 1.0),
            torch.ones_like(gnorm1))
        if bounded:
            x_new, f_new, g_new, ls_nfev, ls_ok = \
                _projected_backtracking_ls(value_and_grad, x, d, f, g,
                                           a_init, lo, hi, opts, run)
        else:
            a, f_new, g_new, ls_nfev, ls_ok = _wolfe_line_search(
                value_and_grad, x, d, f, g, dphi0, a_init, big, opts, run)
            x_new = _step(x, a, d)

        # history update (skip on tiny curvature)
        sv = x_new - x
        yv = g_new - g
        sy_d = _dot(sv, yv)
        sy, ss, yy, pgn = _host(sy_d, _dot(sv, sv), _dot(yv, yv),
                                _pgnorm(x_new, g_new, lo, hi))
        good = run & ls_ok & (sy > 1e-10 * torch.sqrt(ss) * torch.sqrt(yy)) \
            & (sy > 0)
        good_d = good.to(device)
        gk = good_d[:, None]
        H[rows, head_d] = torch.where(gk, sv, H[rows, head_d])
        H[rows, m + head_d] = torch.where(gk, yv, H[rows, m + head_d])
        rho[rows, head_d] = torch.where(
            good_d, 1.0 / torch.clamp_min(sy_d, 1e-300), rho[rows, head_d])
        head = torch.where(good, (head + 1) % m, head)
        hlen = torch.where(good, torch.clamp_max(hlen + 1, m), hlen)

        x, g, f, niter, nfev, status, done = _end_iteration(
            opts, run, ls_ok, ls_nfev, pgn, x, x_new, g, g_new, f, f_new,
            niter, nfev, status, done)

    res = LBFGSResult(x=x, f=f.to(device), g=g, niter=niter.to(device),
                      nfev=nfev.to(device), status=status.to(device),
                      pgnorm=_pgnorm(x, g, lo, hi))
    if one:
        res = LBFGSResult(*(t[0] for t in res))
    return res
