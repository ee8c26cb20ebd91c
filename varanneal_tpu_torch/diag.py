"""Diagnostics for annealing ensembles, in the port.

Counterpart of ``varanneal_tpu/diag.py``. The NumPy functions are copies
(the port imports nothing of the JAX package): the level clustering of an
ensemble's final actions (``action_levels``), the member at the lowest
level (``estimate_from_ensemble``), the twin experiment's path error
(``path_rmse``), the Fisher-information report of sensitivity matrices
(``fisher_report``) and the action-vs-β figure (``plot_action_levels``,
which imports matplotlib only when called). ``forward_sensitivity`` is
the same RK4 simulation written in torch and differentiated in forward
mode with ``torch.func.jacfwd`` (the reference uses ``jax.jacfwd`` over
``lax.scan``); it runs on the CUDA card unless the caller passes
``device='cpu'``.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device


class ActionLevels(NamedTuple):
    levels: np.ndarray        # (n_levels,) sorted unique action plateaus
    counts: np.ndarray        # (n_levels,) members per level
    assignment: np.ndarray    # (B,) level index per member
    best_members: np.ndarray  # indices of members at the lowest level


def action_levels(A_final, rel_gap: float = 0.05) -> ActionLevels:
    """Cluster the final (highest-β) action values of an ensemble into
    levels: two members share a level if their actions differ by less than
    ``rel_gap`` relatively. Returns levels sorted ascending."""
    A_final = np.asarray(A_final, float)
    order = np.argsort(A_final)
    levels = []
    assignment = np.empty(len(A_final), int)
    for idx in order:
        a = A_final[idx]
        if levels and a <= levels[-1][0] * (1 + rel_gap) + 1e-300:
            levels[-1][1].append(idx)
        else:
            levels.append((a, [idx]))
        assignment[idx] = len(levels) - 1
    lv = np.asarray([l[0] for l in levels])
    counts = np.asarray([len(l[1]) for l in levels])
    return ActionLevels(levels=lv, counts=counts, assignment=assignment,
                        best_members=np.asarray(levels[0][1]))


def estimate_from_ensemble(A, paths_or_final):
    """The VA estimate: the member(s) at the lowest consistent action
    level. ``A``: (B, Nβ) ladders; ``paths_or_final``: (B, ...) per-member
    results. Returns (best_index, selected_result, ActionLevels)."""
    A = np.asarray(A)
    lv = action_levels(A[:, -1])
    best = int(lv.best_members[0])
    return best, np.asarray(paths_or_final)[best], lv


def path_rmse(X_est, X_true, Lidx=None, D=None):
    """RMSE split into observed/unobserved components (the twin
    experiment's quality metric). ``Lidx`` observed columns; D total state
    dimension."""
    X_est = np.asarray(X_est)
    X_true = np.asarray(X_true)
    if Lidx is None:
        return float(np.sqrt(np.mean((X_est - X_true) ** 2)))
    Lidx = list(Lidx)
    D = D or X_true.shape[-1]
    unobs = [i for i in range(D) if i not in Lidx]
    out = {
        "observed": float(np.sqrt(np.mean(
            (X_est[..., Lidx] - X_true[..., Lidx]) ** 2))),
    }
    if unobs:
        out["unobserved"] = float(np.sqrt(np.mean(
            (X_est[..., unobs] - X_true[..., unobs]) ** 2)))
    return out


def forward_sensitivity(f, x0, t, P, pidx=None, *, stim=None, obs=(0,),
                        sub=10, relative=True, device=None):
    """Forward sensitivities of the observed trajectory components with
    respect to the estimated parameters (the local-identifiability
    primitive of a Fisher analysis).

    Integrates ``f(t, x, p)`` from ``x0`` over the uniform grid ``t`` with
    classic RK4 on a ``sub``-times finer grid (the integrator of
    ``twin.py``), in float64 on ``device``, and differentiates the sampled
    observations in forward mode (``torch.func.jacfwd``: one tangent per
    estimated parameter, the efficient direction for NPest << N·len(obs)).

    Args:
      f: the port's model ``f(t, x, p)`` with ``x`` shaped (1, D); with
        ``stim``, ``p`` is passed as ``(params, stim_rows)`` with
        stim_rows (1, S), the driven-model convention of models/nakl.py.
      x0: (D,) initial state.
      t: (N,) uniform time grid of the observations.
      P: full parameter vector.
      pidx: estimated-parameter indices into ``P`` (default: all).
      stim: optional (N,) or (N, S) stimulus on the observation grid,
        linearly interpolated onto the fine grid (``np.interp``).
      obs: observed state-component indices (``Lidx``).
      sub: RK4 substeps per observation interval.
      relative: scale column j by ``P[pidx[j]]`` (sensitivities per
        relative parameter move); zero-valued parameters keep absolute
        scaling.
      device: torch device; ``None`` means the CUDA card.

    Returns:
      S: (N * len(obs), NPest) float64 NumPy array, rows time-major (all
      observed components of t_0, then t_1, ...).
    """
    device = resolve_device(device)
    t = np.asarray(t, np.float64)
    N = t.shape[0]
    if N < 2:
        raise ValueError("need at least 2 observation times")
    dts = np.diff(t)
    if not np.allclose(dts, dts[0], rtol=1e-6, atol=0.0):
        raise ValueError("forward_sensitivity requires a uniform grid")
    dt = float(dts[0])
    pidx = list(range(len(np.asarray(P)))) if pidx is None else list(pidx)
    obs = list(obs)
    h = dt / sub
    n_fine = (N - 1) * sub
    t_fine = t[0] + h * np.arange(n_fine)
    stim_f = None
    if stim is not None:
        stim = np.asarray(stim, np.float64)
        if stim.ndim == 1:
            stim = stim[:, None]
        stim_f = torch.tensor(np.stack([np.interp(t_fine, t, stim[:, j])
                                        for j in range(stim.shape[1])],
                                       axis=-1), device=device)

    def on_dev(a, dtype=torch.float64):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    P_full = on_dev(np.asarray(P, np.float64))
    pidx_t = on_dev(pidx, torch.long)
    obs_t = on_dev(obs, torch.long)
    x_0 = on_dev(np.asarray(x0, np.float64))
    t_rows = on_dev(t_fine)[:, None]

    def sim(p_est):
        p = P_full.index_copy(0, pidx_t, p_est)

        def f1(tk, x, i):
            pk = p if stim_f is None else (p, stim_f[i:i + 1])
            return f(tk, x[None, :], pk)[0]

        x = x_0
        out = [x_0.index_select(0, obs_t)]
        for i in range(n_fine):
            tk = t_rows[i]
            k1 = f1(tk, x, i)
            k2 = f1(tk + h / 2, x + h / 2 * k1, i)
            k3 = f1(tk + h / 2, x + h / 2 * k2, i)
            k4 = f1(tk + h, x + h * k3, i)
            x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            if (i + 1) % sub == 0:
                out.append(x.index_select(0, obs_t))
        return torch.cat(out)

    J = torch.func.jacfwd(sim)(P_full.index_select(0, pidx_t))
    S = J.detach().cpu().numpy().astype(np.float64)
    if relative:
        scale = np.asarray(P, np.float64)[pidx]
        scale = np.where(scale == 0.0, 1.0, scale)
        S = S * scale[None, :]
    return S


class FisherReport(NamedTuple):
    F: np.ndarray          # (NP, NP) Fisher information (relative basis)
    eigvals: np.ndarray    # ascending
    eigvecs: np.ndarray    # columns match eigvals
    crlb: np.ndarray       # (NP,) relative 1-sigma Cramér–Rao lower bounds
    flat: list             # [(eigval, [(coeff, name), ...]), ...] below cut


def fisher_report(S, sigma=1.0, names=None, flat_cut=None,
                  n_components=4) -> FisherReport:
    """Fisher-information analysis of one or more sensitivity matrices.

    ``S``: a single (M, NP) matrix from :func:`forward_sensitivity`, or a
    list of them (a multi-protocol design stacks information: F = Σ_k
    F_k). ``sigma``: measurement noise (units of the observations).
    ``flat_cut``: eigenvalue threshold below which a direction is reported
    as flat; default M (a 100 % relative move along an eigendirection with
    λ < M changes the trace by < 1 σ rms). ``names``: parameter labels for
    the flat-direction report."""
    Ss = S if isinstance(S, (list, tuple)) else [S]
    NP_ = Ss[0].shape[1]
    M = sum(s.shape[0] for s in Ss)
    F = sum(np.asarray(s, np.float64).T @ np.asarray(s, np.float64)
            for s in Ss) / float(sigma) ** 2
    w, V = np.linalg.eigh(F)
    cut = float(M) / float(sigma) ** 2 if flat_cut is None else flat_cut
    names = ([f"p{j}" for j in range(NP_)] if names is None
             else list(names))
    flat = []
    for i in range(len(w)):
        if w[i] >= cut:
            continue
        v = V[:, i]
        top = np.argsort(-np.abs(v))[:n_components]
        flat.append((float(w[i]), [(float(v[j]), names[j]) for j in top]))
    # pseudo-inverse: a singular F (true flat directions) gives the CRLB
    # restricted to the identifiable subspace instead of raising
    Finv = np.linalg.pinv(F, hermitian=True)
    crlb = np.sqrt(np.maximum(np.diag(Finv), 0.0))
    return FisherReport(F=F, eigvals=w, eigvecs=V, crlb=crlb, flat=flat)


def plot_action_levels(A, beta_array=None, ax=None, fname: Optional[str]
                       = None, log: bool = True):
    """Render the action-vs-β ensemble figure. ``A``: (B, Nβ) or (Nβ,).
    Saves to ``fname`` if given; returns the matplotlib Axes. matplotlib
    is imported here, so the module imports without it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    A = np.atleast_2d(np.asarray(A))
    beta = (np.arange(A.shape[1]) if beta_array is None
            else np.asarray(beta_array))
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    for b in range(A.shape[0]):
        ax.plot(beta, A[b], lw=0.7, alpha=min(1.0, 4.0 / A.shape[0]),
                color="C0")
    if log:
        ax.set_yscale("log")
    ax.set_xlabel(r"annealing step $\beta$")
    ax.set_ylabel("action level")
    ax.set_title(f"ensemble action levels (B={A.shape[0]})")
    if fname:
        ax.figure.savefig(fname, dpi=120, bbox_inches="tight")
    return ax
