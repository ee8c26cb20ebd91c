"""The kernels' built-in models on the host: which model a vector field
is, the conditions a kernel puts on it, the parameter rows a kernel
reads, and the plain PyTorch f, Jᵀv and parameter adjoint that the
kernels' plain versions evaluate.

K6 (``kernels/fe.py``) and K1, K4, K2 and K3 (``kernels/ag.py``,
``kernels/solve.py``) both import it. A constants object ``c`` here is
either kernel's (``fe.FeConsts`` or ``ag.AgConsts``): it names its model
(``c.model``), its parameters (``c.pidx``, ``c.pidx_t``, ``c.P_lin``,
``c.NP``, ``c.direct``, the log masks ``c.log_mask``/``c.pest_log``) and
its stimulus (``c.stim``, the injected current of each model-grid row, or
None). Lorenz-96's f and Jᵀv are the roll stencils of ``csrc/l96_ag.cuh``;
a row-level model (NaKL, Colpitts, Lorenz-63: a thread owns a whole state
row on the card) is the port's torch model, its adjoint taken with
``torch.func.vjp``, a derivation independent of the hand-written one in
``csrc/nakl.cuh``, ``colpitts.cuh`` and ``l63.cuh``.
"""

import numpy as np
import torch

from varanneal_tpu_torch.models.colpitts import colpitts
from varanneal_tpu_torch.models.lorenz import lorenz63, lorenz96
from varanneal_tpu_torch.models.nakl import nakl

#: The kernels' models by the port's vector field.
_MODEL_OF = {lorenz96: "l96", nakl: "nakl", colpitts: "colpitts",
             lorenz63: "l63"}
#: The parameter count of each model, and the parameter row the kernels
#: stage (kNPX: NaKL's 19 values, 1/Cm and three 1/dva; the others' own
#: values).
MODEL_NP = {"l96": 1, "nakl": 19, "colpitts": 4, "l63": 3}
MODEL_NPX = {"l96": 1, "nakl": 23, "colpitts": 4, "l63": 3}
#: The port's torch model of each row-level model.
ROW_F = {"nakl": nakl, "colpitts": colpitts, "l63": lorenz63}
#: A D = 3 model's name in a refusal.
_NAME_3 = {"colpitts": "Colpitts", "l63": "Lorenz-63"}


def model_of(f):
    """``(model, log_idx)`` of a vector field the kernels take: ('l96', ())
    for ``lorenz96``, ('nakl', ()) for ``nakl``, ('colpitts', ()) for
    ``colpitts``, ('l63', ()) for ``lorenz63``, ('nakl', log_idx) for a
    model of ``nakl_log_model``; None for any other."""
    if f in _MODEL_OF:
        return _MODEL_OF[f], ()
    log_idx = getattr(f, "log_idx", None)
    if getattr(f, "base", None) is nakl and isinstance(log_idx, tuple):
        return "nakl", log_idx
    return None


def row_model_refusal(spec, model, log_idx=()):
    """The first condition a row-level model's problem fails (its state
    width, its parameter count, ``pidx`` distinct and in range, the log
    coordinates in range, the stimulus: NaKL column 0 of an (N_f, S)
    ``stim_f``, Colpitts and Lorenz-63 none), or None."""
    if model in _NAME_3:
        name, NP = _NAME_3[model], MODEL_NP[model]
        if spec.D != 3:
            return f"{name} with D = {spec.D} (its state has 3 components)"
        if spec.NP != NP:
            return f"{name} with NP = {spec.NP} (it has {NP} parameters)"
        if (len(set(spec.pidx)) != len(spec.pidx)
                or not all(0 <= j < NP for j in spec.pidx)):
            return f"{name} with pidx {spec.pidx}"
        if spec.stim_f is not None:
            return f"{name} with a stimulus"
        return None
    if spec.D != 4:
        return f"NaKL with D = {spec.D} (its state is [V, m, h, n])"
    if spec.NP != 19:
        return f"NaKL with NP = {spec.NP} (it has 19 parameters)"
    if (len(set(spec.pidx)) != len(spec.pidx)
            or not all(0 <= j < 19 for j in spec.pidx)):
        return f"NaKL with pidx {spec.pidx}"
    if not all(0 <= j < 19 for j in log_idx):
        return f"NaKL with log coordinates {log_idx}"
    if spec.stim_f is not None and (
            np.ndim(spec.stim_f) != 2
            or np.shape(spec.stim_f)[0] != spec.N_f
            or np.shape(spec.stim_f)[1] < 1):
        return (f"a stimulus of shape {np.shape(spec.stim_f)} (the "
                f"kernels read column 0 of ({spec.N_f}, S))")
    return None


def full_params(pest, c):
    """The parameter rows, (B, NP) in ``pest``'s dtype: the estimated
    values ``pest`` (B, NPest) merged into the fixed ones at ``pidx`` (the
    reference's ``_merge``), a log model's coordinates exponentiated
    (linear parameters). ``pest`` itself where ``c.direct`` holds,
    ``P_lin`` broadcast where nothing is estimated."""
    if c.direct:
        return pest
    B = pest.shape[0]
    P_lin = c.P_lin.to(pest.dtype)
    if not c.pidx:
        return P_lin.expand(B, c.NP)
    v = pest if c.pest_log is None else torch.where(
        c.pest_log, torch.exp(pest), pest)
    return P_lin.expand(B, c.NP).clone().index_copy_(1, c.pidx_t, v)


def param_rows(pest, c):
    """(P, row stride) as the kernels read the parameter rows: ``pest``
    with its own stride where ``c.direct`` holds, ``P_lin`` with stride 0
    where nothing is estimated, else the merged rows of
    :func:`full_params`."""
    if not c.pidx:
        return c.P_lin, 0
    P = full_params(pest, c)
    if c.NP > 1 and P.stride(1) != 1:
        P = P.contiguous()
    return P, P.stride(0)


def param_grad(gp, P, c):
    """The gradient over the full estimation-scale parameter vector (B, NP)
    from the kernels' per-block partials ``gp`` (B, NP, blocks), summed
    over blocks in order; a log coordinate's gradient times its linear
    value ``P`` (:func:`full_params`), the chain rule through exp."""
    g = gp.sum(dim=-1)
    if c.log_mask is not None:
        g = torch.where(c.log_mask, g * P, g)
    return g


def pest_grad(g, c):
    """The gradient over the estimated values (B, NPest) from the full one
    (B, NP): its columns at ``pidx``."""
    return g if c.direct else g.index_select(1, c.pidx_t)


def roll(x, k):
    return torch.roll(x, k, dims=-1)


def l96_f(X, F):
    """Lorenz-96's f on every row of X (..., D): l96_f."""
    return (roll(X, -1) - roll(X, 2)) * roll(X, 1) - X + F


def l96_jtv(X, v):
    """(J(x)ᵀ v) on every row: l96_jtv."""
    return (roll(X, 2) * roll(v, 1)
            + (roll(X, -2) - roll(X, 1)) * roll(v, -1)
            - roll(X, -1) * roll(v, -2)
            - v)


def stim_rows(c, X, sl):
    """The injected current of model-grid rows ``sl`` as an (R, 1) tensor
    on X's device, or None without a stimulus."""
    return None if c.stim is None else c.stim.to(X.dtype)[sl, None]


def model_rows(X, P, stim, c):
    """The port's torch model of a row-level model on rows X (B, R, D)
    with parameter rows P (B, NP) or (B, R, NP) and currents ``stim``
    (R, 1) or None."""
    Pr = P[:, None, :] if P.ndim == 2 else P
    return ROW_F[c.model](None, X, Pr if stim is None else (Pr, stim))


def f_rows(X, P, c, sl=slice(None)):
    """f on the rows X (B, R, D) (model-grid rows ``sl``)."""
    if c.model == "l96":
        return l96_f(X, P[:, :1].reshape(-1, 1, 1))
    return model_rows(X, P, stim_rows(c, X, sl), c)


def row_vjp(X, P, v, c, sl):
    """(J(x)ᵀ v per row (B, R, D), the rows' parameter adjoints
    Σ_d df_d/dp v_d (B, R, NP)) of a row-level model at rows X
    (model-grid rows ``sl``), by torch.func.vjp of the torch model."""
    stim = stim_rows(c, X, sl)
    Pr = P[:, None, :].expand(X.shape[0], X.shape[1], P.shape[-1])
    _, vjp = torch.func.vjp(lambda x, p: model_rows(x, p, stim, c), X, Pr)
    return vjp(v)
