"""K1, K4 and K5: the fused action + gradient, one launch per
evaluation: K1 (Lorenz-96 and the built-in row-level models NaKL,
Colpitts and Lorenz-63, the four rules, a scalar or (N_f-1, D) rf), K4
(K1 with compensated sums) and K5 (Lorenz-96 at small D, three one-step
rules, scalar or (N_f-1, D) rf).

Counterpart of ``varanneal_tpu/kernels/ag_pallas.py`` (``ag_supported``,
``embed_consts``, ``make_action_ag``, ``_combine``), whose ``_ag_kernel``
this replaces on the card with the hand-written CUDA kernels in
``csrc/ag_kernel.cu`` (the trapezoid rule with a scalar rf) and
``csrc/ag_rules_kernel.cu`` (Euler, the forward map, Hermite–Simpson and
the trapezoid rule, each with a scalar or (N_f-1, D) rf, less the
trapezoid/scalar pair), both on Lorenz-96, and ``csrc/ag_models_kernel.cu``
(NaKL with or without its stimulus, Colpitts and Lorenz-63 under every
rule and rf kind: a walk in time by thread, ``csrc/row_ag_block.cuh``);
the sources note what bounds them and what their design does about
that. K4 is ``_ag_kernel(comp=True)``: K1's value and
gradient plus a (B, 6) row of two-float sums of the ME terms and of the FE
terms (unweighted under a scalar rf, weighted under an (N_f-1, D) one; the
Hermite plane apart under Hermite–Simpson), which :func:`combine` joins
and scales in the combine dtype of ``ops.action`` (float64 for an f32 path
when torch's default dtype is float64), so that
``make_action_ag(compensated=True)`` returns the compensated action's
value with K1's f32 gradient. K5 replaces ``_agt_kernel``
(``make_action_ag_t``, the reference's transposed-layout kernel for D <=
64) with ``csrc/agt_kernel.cu``, K1's walk in time with the rule and the
rf kind as template arguments: the action of ``ops.action.make_action``
under the trapezoid rule, Euler or a forward map with a scalar or
(N_f-1, D) rf, observations at every ``obs_stride``-th model row (the
reference's K5 puts them at rows 0..N_data-1 and takes Hermite–Simpson
for a forward map: ROADMAP.md §3; the port follows the XLA action).
Beside the kernels this module holds:

- :func:`ag_reference`, the one plain PyTorch version of K1, K4 and K5
  under every rule and rf kind, on every model K1 takes (and of the
  evaluation inside K2/K3): it spells out each rule's adjoint (the
  residuals' gradient, Jᵀv at each node and the parameter adjoint) rather
  than calling autograd on the action, so the CPU tests check the
  arithmetic the CUDA code does; the model's f, Jᵀv and parameter
  adjoint are ``kernels/rowmodel.py``'s (Lorenz-96's stencils, a row-level
  model's torch function and its ``torch.func.vjp``); with
  ``compensated=True`` it also returns K4's row, the same terms summed by
  ``ops.action.comp_sum_pair``;
- :data:`LAUNCHES` (K1), :data:`COMP_LAUNCHES` (K4) and
  :data:`AGT_LAUNCHES` (K5), plain counts of kernel launches,
  :data:`RULE_LAUNCHES`, K1's and K4's launches of Lorenz-96's rules'
  entries by rule and rf kind, and :data:`MODEL_LAUNCHES`, their
  launches on the row-level models by model, rule and rf kind;
- :func:`ag_supported` and :func:`agt_supported`, the kernels' envelopes,
  and :func:`ag_refusal` and :func:`agt_refusal`, the condition each
  fails, in words.

:func:`action_and_grad` and :func:`action_and_grad_t` take the plain
version only for tensors on the CPU. For a CUDA tensor they launch the
kernel or raise; they never fall back.
"""

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.kernels import rowmodel
from varanneal_tpu_torch.ops import action as _action
from varanneal_tpu_torch.ops.spec import ProblemSpec

#: K1 launches so far; each successful launch adds one.
LAUNCHES = 0
#: K4 (compensated) launches so far; each successful launch adds one.
COMP_LAUNCHES = 0
#: K5 (one-step, small D) launches so far; each successful launch adds one.
AGT_LAUNCHES = 0
#: K1's and K4's launches of the rules' entries (csrc/ag_rules_kernel.cu)
#: so far, by "<disc>/<rf kind>" ("scalar" or "diag") and "comp" for K4;
#: each also counts in LAUNCHES or COMP_LAUNCHES.
RULE_LAUNCHES = {}
#: K1's and K4's launches on the row-level models
#: (csrc/ag_models_kernel.cu) so far, by "<model>/<disc>/<rf kind>" and
#: "/comp" for K4 (:func:`model_key`); each also counts in LAUNCHES or
#: COMP_LAUNCHES.
MODEL_LAUNCHES = {}
#: The row-level models of K1-K4 (csrc/row_models.cuh).
ROW_MODELS = ("nakl", "colpitts", "l63")

#: The walk's rules and their codes (WalkDisc in csrc/l96_ag_block.cuh).
DISCS = {"trapezoid": 0, "euler": 1, "forwardmap": 2, "SimpsonHermite": 3}
#: K5's discretizations and their codes in csrc/agt_kernel.cu.
AGT_DISCS = {"trapezoid": 0, "euler": 1, "forwardmap": 2}
#: K5's largest D (the reference's small-D limit).
AGT_MAX_D = 64

#: Shared memory one H100 block can opt into (227 KB).
SMEM_LIMIT = 232448
_THREADS = 256          # kThreads in csrc/ag_kernel.cu
_WARPS = _THREADS // 32
_DTYPES = (torch.float32, torch.float64)
#: Rows of a warp's ring in the block routine (kRingRows in
#: csrc/l96_ag_block.cuh).
RING_ROWS = 6
#: The routine's sums a warp, plain and with K4's (hi, lo) pairs
#: (kAgSums, kAgCompSums), and with the rules' entries' pairs, the Hermite
#: plane's among them (kAgRuleCompSums).
AG_SUMS, AG_COMP_SUMS, AG_RULE_COMP_SUMS = 3, 7, 9
#: Most values of a member's decision vector: the kernels index it with
#: 32-bit ints.
MAX_N_DOF = 2**31 - 1


def ring_elems(D, warps=_WARPS):
    """l96_ag_ring_elems: the rings of a group of ``warps`` warps, in
    elements (``RING_ROWS`` rows of D a warp; not N)."""
    return RING_ROWS * D * warps


def _smem_bytes(D, dtype, compensated=False, rules=False):
    """l96_ag_smem_elems in bytes: the warps' partials (with K4's (hi, lo)
    partials when ``compensated``; ``rules``: those of the rules' entries)
    and their rings. It does not grow with N."""
    comp = AG_RULE_COMP_SUMS if rules else AG_COMP_SUMS
    parts = (comp if compensated else AG_SUMS) * _WARPS
    return (parts + ring_elems(D)) * (torch.finfo(dtype).bits // 8)


def row_area_elems(model, compensated=False, warps=_WARPS):
    """row_area_elems of csrc/row_ag_block.cuh: a row-level model's staged
    parameter row and the warps' partials (FE, ME and the NP parameter
    sums; with K4's pairs six more a warp)."""
    sums = 2 + rowmodel.MODEL_NP[model] + (6 if compensated else 0)
    return rowmodel.MODEL_NPX[model] + sums * warps


def ring_cols(c, warps=_WARPS) -> int:
    """The width whose rings (:func:`ring_elems`) a group of ``warps``
    warps gives a problem's evaluation (``ring_cols`` of the CUDA
    sources; K2/K3's eight by default, K8's groups one or two):
    Lorenz-96's D, or for a row-level model the fewest columns whose
    rings hold its area at that many warps. ``c``: the kernel's constants
    (:class:`AgConsts`) or the problem (``ProblemSpec``)."""
    model = (c.model if isinstance(c, AgConsts)
             else rowmodel.model_of(c.f)[0])
    if model == "l96":
        return c.D
    per = RING_ROWS * warps
    return -(-row_area_elems(model, warps=warps) // per)


def ring_on_chip(D, dtype, compensated=False, rules=False) -> bool:
    """Whether K1/K4's rings fit in a block's shared memory with the
    partials (D up to 1,210 in float32 and 604 in float64, 1,209 and
    604 with K4's partials, 1,209 and 603 with those of the rules'
    entries); where they do not, the wrapper passes a workspace of
    :func:`ring_elems` a member."""
    return _smem_bytes(D, dtype, compensated, rules) <= SMEM_LIMIT


def _grid_dt(spec: ProblemSpec) -> float:
    """The model grid's row spacing: dt, or dt/2 on Hermite–Simpson's
    doubled grid (``ops/spec.py``)."""
    return spec.dt / 2.0 if spec.disc == "SimpsonHermite" else spec.dt


def _uniform_grid(spec: ProblemSpec) -> bool:
    t_f = np.asarray(spec.t_f)
    ref = t_f[0] + _grid_dt(spec) * np.arange(t_f.shape[0])
    return bool(np.allclose(t_f, ref, rtol=1e-12, atol=1e-9))


def ag_refusal(spec: ProblemSpec, rf=0.0, dtype=torch.float32,
               compensated=False):
    """The first condition of :func:`ag_supported` that ``spec`` fails, in
    words, or None inside the envelope. ``compensated`` (K4) asks for
    nothing more: its larger partials only move the rings off chip
    sooner."""
    del compensated
    if spec.disc not in DISCS:
        return (f"disc {spec.disc!r} (K1 takes the trapezoid rule, euler, "
                f"forwardmap and SimpsonHermite)")
    m = rowmodel.model_of(spec.f)
    if m is None:
        return (f"model {getattr(spec.f, '__name__', spec.f)!r} (K1 takes "
                f"Lorenz-96, NaKL, Colpitts and Lorenz-63, each with its "
                f"f, Jᵀv and parameter adjoint written by hand; a user "
                f"model waits for ROADMAP.md §2a item 2 (f))")
    model, log_idx = m
    if model == "l96":
        if spec.D < 4:
            return f"D = {spec.D} (Lorenz-96 needs D >= 4)"
        if spec.stim_f is not None:
            return "a stimulus (K1 takes none on Lorenz-96)"
        if (spec.time_dep_p or spec.NP != 1
                or spec.pidx not in ((), (0,))):
            return ("parameters (K1 takes the one constant F, estimated "
                    "or fixed)")
    else:
        if log_idx:
            return ("the log-space NaKL model (models.nakl_log_model): the "
                    "reference's K1 takes it and cannot launch it "
                    "(ROADMAP.md §3, reference fault 7)")
        if spec.time_dep_p:
            return "time-dependent parameters (K1 takes constant ones)"
        why = rowmodel.row_model_refusal(spec, model)
        if why is not None:
            return why
    if np.ndim(rf) != 0 and np.shape(rf) != (spec.N_f - 1, spec.D):
        return (f"rf of shape {np.shape(rf)} (K1 takes a scalar or "
                f"({spec.N_f - 1}, {spec.D}) rf; a per-member rf is "
                f"outside it)")
    if np.ndim(spec.RM) not in (0, 2):
        return (f"RM rank {np.ndim(spec.RM)} (K1 takes a scalar or "
                f"(N_data, L) RM)")
    if dtype not in _DTYPES:
        return f"dtype {dtype} (K1 takes float32 or float64)"
    if spec.disc == "SimpsonHermite" and spec.N_f % 2 != 1:
        return (f"N_f = {spec.N_f} under Hermite–Simpson (K1 takes whole "
                f"intervals: an odd N_f)")
    if not _uniform_grid(spec):
        return "a non-uniform time grid"
    if len(set(np.asarray(spec.Lidx).tolist())) != spec.L:
        return ("repeated observed columns in Lidx (the reference's K1 "
                "takes them and departs from the XLA action there: "
                "ROADMAP.md §3, fault 6)")
    if spec.n_dof > MAX_N_DOF:
        return (f"size: n_dof = {spec.n_dof:,} values, above the kernels' "
                f"32-bit index range of {MAX_N_DOF:,}")
    return None


def ag_supported(spec: ProblemSpec, rf=0.0, dtype=torch.float32,
                 compensated=False) -> bool:
    """The kernels' envelope: Lorenz-96 (the port's
    ``models.lorenz.lorenz96``, D >= 4, no stimulus, F estimated or
    fixed), NaKL (``models.nakl.nakl``, with or without its stimulus:
    column 0 of an (N_f, S) ``stim_f``), Colpitts
    (``models.colpitts.colpitts``) and Lorenz-63
    (``models.lorenz.lorenz63``), those three with any distinct ``pidx``
    (``kernels.fe.fe_refusal``'s model conditions, less NaKL's log-space
    model: reference fault 7), under any of the four rules (an odd N_f
    under Hermite–Simpson), constant parameters, a scalar or (N_f-1, D)
    rf, a scalar or (N_data, L) RM, distinct observed columns, a uniform
    grid, f32 or f64, and at most :data:`MAX_N_DOF` values a member. A
    per-member (B, N_f-1, D) rf is outside it. Shared memory bounds
    nothing: Lorenz-96's routine walks the path in time and keeps 6 rows
    of D a warp, on chip where they fit (:func:`ring_on_chip`) and else in
    a workspace, and a row-level model's walk keeps its nodes in
    registers, so N and D are free up to the index range (the reference's
    K1 stops at 2²¹ padded values). :func:`ag_refusal` names the
    condition a problem fails."""
    return ag_refusal(spec, rf, dtype, compensated) is None


def agt_refusal(spec: ProblemSpec, rf=0.0, dtype=torch.float32):
    """The first condition of :func:`agt_supported` that ``spec`` fails, in
    words, or None inside K5's envelope."""
    if spec.disc not in AGT_DISCS:
        return (f"disc {spec.disc!r} (K5 takes the trapezoid rule, euler "
                f"and forwardmap)")
    if rowmodel.model_of(spec.f) != ("l96", ()):
        return (f"model {getattr(spec.f, '__name__', spec.f)!r} (K5 takes "
                f"Lorenz-96, models.lorenz.lorenz96)")
    if not 4 <= spec.D <= AGT_MAX_D:
        return f"D = {spec.D} (K5 takes 4 <= D <= {AGT_MAX_D})"
    if (spec.time_dep_p or spec.stim_f is not None or spec.NP != 1
            or spec.pidx not in ((), (0,))):
        return ("parameters (K5 takes the one constant F, estimated or "
                "fixed, and no stimulus)")
    if np.ndim(rf) != 0 and np.shape(rf) != (spec.N_f - 1, spec.D):
        return (f"rf of shape {np.shape(rf)} (K5 takes a scalar or "
                f"({spec.N_f - 1}, {spec.D}) rf)")
    if np.ndim(spec.RM) not in (0, 2):
        return (f"RM rank {np.ndim(spec.RM)} (K5 takes a scalar or "
                f"(N_data, L) RM)")
    if dtype not in _DTYPES:
        return f"dtype {dtype} (K5 takes float32 or float64)"
    if not _uniform_grid(spec):
        return "a non-uniform time grid"
    if len(set(np.asarray(spec.Lidx).tolist())) != spec.L:
        return "repeated observed columns in Lidx"
    if spec.n_dof > MAX_N_DOF:
        return (f"size: n_dof = {spec.n_dof:,} values, above the kernels' "
                f"32-bit index range of {MAX_N_DOF:,}")
    return None


def agt_supported(spec: ProblemSpec, rf=0.0, dtype=torch.float32) -> bool:
    """K5's envelope: Lorenz-96 (the port's ``models.lorenz.lorenz96``)
    with 4 <= D <= :data:`AGT_MAX_D`, the trapezoid rule, Euler or a
    forward map (Hermite–Simpson refused), no stimulus, constant
    parameters with NP == 1, rf scalar or (N_f-1, D), RM scalar or
    (N_data, L), any uniform observation stride, distinct observed
    columns, a uniform grid, f32 or f64, and at most :data:`MAX_N_DOF`
    values a member. A per-member (B, N_f-1, D) rf is outside it. Shared
    memory bounds nothing: K1's walk keeps 6 rows of D a warp, whatever
    N. :func:`agt_refusal` names the condition a problem fails."""
    return agt_refusal(spec, rf, dtype) is None


@dataclasses.dataclass(frozen=True)
class AgConsts:
    """The kernel's constants for one problem, on one device and dtype
    (the counterpart of ``embed_consts``: no padding or embedding, since
    the kernel reads X straight from the flat decision vector)."""
    N: int
    D: int
    n_state: int
    n_dof: int
    pslot: int              # index of F in XP, or -1 when F is fixed
    F_fixed: float
    obs_stride: int
    N_data: int
    L: int
    h: float
    me_norm: float
    fe_norm: float
    Y: torch.Tensor         # (N_data, L)
    W: torch.Tensor         # (N_data, L) RM weights
    lidx: torch.Tensor      # (L,) int32 observed columns
    lpos: torch.Tensor      # (D,) int32 position in lidx, or -1
    obs_rows: torch.Tensor  # (N_data,) int64 observed model rows
    device: torch.device
    dtype: torch.dtype
    disc: str = "trapezoid"
    # the model ('l96' or a row-level model) and, for a row-level model,
    # its parameters (rowmodel's names: the fixed row P_lin, the
    # estimated pidx; pmap each parameter's position among the estimated
    # or -1) and its stimulus (the (N_f,) current, or None)
    model: str = "l96"
    pidx: tuple = ()
    P_base: tuple = ()
    P_lin: Optional[torch.Tensor] = None
    pidx_t: Optional[torch.Tensor] = None
    pidx_k: Optional[torch.Tensor] = None     # pidx as the kernels read it
    pmap: Optional[torch.Tensor] = None
    stim: Optional[torch.Tensor] = None
    log_mask = None             # K1 takes no log-space model
    pest_log = None

    @property
    def NP(self) -> int:
        return len(self.P_base)

    @property
    def direct(self) -> bool:
        """Whether the estimated values are the parameter row itself."""
        return self.model != "l96" and self.pidx == tuple(range(self.NP))


def ag_consts(spec: ProblemSpec, device, dtype,
              compensated=False) -> AgConsts:
    """Build :class:`AgConsts` for ``spec`` (which must be supported)."""
    why = ag_refusal(spec, 0.0, dtype, compensated)
    if why is not None:
        raise ValueError(f"problem outside the ag kernel's envelope: {why} "
                         f"(see ag_supported); use ops.action.make_action")
    return _consts(spec, device, dtype)


def agt_consts(spec: ProblemSpec, device, dtype) -> AgConsts:
    """K5's :class:`AgConsts` for ``spec`` (inside :func:`agt_supported`
    for a scalar rf), ``disc`` naming its discretization."""
    why = agt_refusal(spec, 0.0, dtype)
    if why is not None:
        raise ValueError(f"problem outside K5's envelope: {why} (see "
                         f"agt_supported); use ops.action.make_action")
    return _consts(spec, device, dtype)


def _consts(spec, device, dtype):
    L = spec.L
    RM = np.asarray(spec.RM, np.float64)
    W = np.broadcast_to(RM, (spec.N_data, L)) if RM.ndim == 0 else RM
    lpos = np.full(spec.D, -1, np.int32)
    lpos[list(spec.Lidx)] = np.arange(L, dtype=np.int32)

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    model = rowmodel.model_of(spec.f)[0]
    P_base = tuple(float(v) for v in np.asarray(spec.P_base))
    row = {}
    if model != "l96":
        pidx = tuple(int(j) for j in spec.pidx)
        pmap = np.full(len(P_base), -1, np.int32)
        pmap[list(pidx)] = np.arange(len(pidx), dtype=np.int32)
        row = dict(
            model=model, pidx=pidx, P_base=P_base,
            P_lin=t(np.asarray(P_base), dtype),
            pidx_t=t(np.asarray(pidx, np.int64), torch.long),
            pidx_k=t(np.asarray(pidx, np.int32), torch.int32),
            pmap=t(pmap, torch.int32),
            stim=(None if spec.stim_f is None else t(
                np.asarray(spec.stim_f, np.float64)[:, 0], dtype)))
    return AgConsts(
        N=spec.N_f, D=spec.D, n_state=spec.n_state, n_dof=spec.n_dof,
        pslot=spec.n_state if spec.NPest and model == "l96" else -1,
        F_fixed=P_base[0],
        obs_stride=spec.obs_stride, N_data=spec.N_data, L=L, h=spec.dt,
        me_norm=1.0 / (L * spec.N_data),
        fe_norm=1.0 / (spec.D * (spec.N_f - 1)),
        Y=t(spec.Y, dtype), W=t(W, dtype),
        lidx=t(np.asarray(spec.Lidx, np.int32), torch.int32),
        lpos=t(lpos, torch.int32),
        obs_rows=t(np.arange(spec.N_data) * spec.obs_stride, torch.int64),
        device=resolve_device(device), dtype=dtype, disc=spec.disc, **row)


def _scalar(v, dtype):
    """A Python float rounded to ``dtype``, as the kernel receives it."""
    return float(torch.tensor(float(v), dtype=dtype))


def measurement_error(X, c: AgConsts):
    """The misfit x_obs - Y on the observed entries of ``X`` (B, N, D)
    and ME = me_norm · Σ W (x_obs - Y)² per member (B,)."""
    diff = X[:, c.obs_rows][:, :, c.lidx.long()] - c.Y
    me = torch.sum(c.W * diff * diff, dim=(1, 2))
    return diff, _scalar(c.me_norm, X.dtype) * me


def _rf_arg(rf, c: AgConsts):
    """(scalar, None) for a scalar rf, else (0.0, the (N_f-1, D) rf as a
    contiguous tensor of c's dtype on c's device). Raises for any other
    shape: a per-member (B, N_f-1, D) rf is outside K1, K2 and K5."""
    if isinstance(rf, torch.Tensor) and rf.ndim == 0:
        return float(rf), None
    if not isinstance(rf, torch.Tensor):
        arr = np.asarray(rf, dtype=np.float64)
        if arr.ndim == 0:
            return float(arr), None
        rf = torch.as_tensor(arr)
    if tuple(rf.shape) != (c.N - 1, c.D):
        raise ValueError(f"the kernels take a scalar or an (N_f-1, D) = "
                         f"({c.N - 1}, {c.D}) rf; got {tuple(rf.shape)}")
    return 0.0, rf.to(device=c.device, dtype=c.dtype).contiguous()


def _onestep_terms(X, f, rfd, c: AgConsts, h, hh, vjp):
    """The one-step rules' residual terms and adjoints (before 2c) (see
    csrc/l96_ag_block.cuh and csrc/row_ag_block.cuh): (fe terms (B, N-1,
    D), Σ q, its multiplier in dA/dF (Lorenz-96), gX / 2c, None: no second
    plane, Σ over nodes of the parameter adjoint at v_n times the rule's
    k (a row-level model, else None)); ``vjp(rows, v, sl)`` gives Jᵀv and
    the rows' parameter adjoints (None for Lorenz-96)."""
    if c.disc == "trapezoid":
        r = X[:, 1:] - X[:, :-1] - hh * (f[:, :-1] + f[:, 1:])
    elif c.disc == "euler":
        r = X[:, 1:] - X[:, :-1] - h * f[:, :-1]
    else:
        r = X[:, 1:] - f[:, :-1]
    q = r if rfd is None else rfd * r            # w_n r_n
    zero = torch.zeros_like(q[:, :1])
    qp = torch.cat([zero, q], dim=1)          # q_{n-1}, zero at n = 0
    qc = torch.cat([q, zero], dim=1)          # q_n, zero at n = N-1
    v = qp + qc if c.disc == "trapezoid" else qc
    jtv, pbar = vjp(X, v, slice(None))
    if c.disc == "trapezoid":
        gX, k = qp - qc - hh * jtv, hh
    elif c.disc == "euler":
        gX, k = qp - qc - h * jtv, h
    else:
        gX, k = qp - jtv, 1.0
    pg = None if pbar is None else k * torch.sum(pbar, dim=1)
    return q * r, torch.sum(q, dim=(1, 2)), (
        1.0 if c.disc == "forwardmap" else h), gX, None, pg


def _sh_terms(X, f, rfd, c: AgConsts, h, vjp):
    """Hermite–Simpson's residual terms and state adjoint (before 2c) on
    the doubled grid, interval k over rows 2k..2k+2 (``ops/disc.py``):

        s_k = x_{2k+2} - x_{2k} - (h/6)(f_{2k} + 4 f_{2k+1} + f_{2k+2})
        m_k = x_{2k+1} - (x_{2k} + x_{2k+2})/2 - (h/8)(f_{2k} - f_{2k+2})

    weighted by rf (a scalar) or by rows 2k and 2k+1 of the (N_f-1, D) rf:
    a_k = w_s s_k, b_k = w_m m_k (zero outside 0..M-1). With v_k =
    (h/6)(a_{k-1} + a_k) + (h/8)(b_k - b_{k-1}):

        gX_{2k}   = a_{k-1} - a_k - (b_{k-1} + b_k)/2 - J(x_{2k})ᵀ v_k
        gX_{2k+1} = b_k - (2h/3) J(x_{2k+1})ᵀ a_k

    and dA/dF = -2c h Σ a (the Hermite terms cancel: ∂f/∂F = 1); a
    row-level model's dA/dp = -2c Σ (F_p(x_{2k})ᵀ v_k + (2h/3)
    F_p(x_{2k+1})ᵀ a_k). Returns (Simpson terms, Σ a, h, gX / 2c, Hermite
    terms, the parameter sum or None), as :func:`_onestep_terms`."""
    dt = X.dtype
    M = (c.N - 1) // 2
    h6 = _scalar(h / 6.0, dt)
    h8 = _scalar(h / 8.0, dt)
    h23 = _scalar(2.0 * h / 3.0, dt)
    xe, xm, xo = X[:, 0:2 * M:2], X[:, 1:2 * M:2], X[:, 2:2 * M + 1:2]
    fe, fm, fo = f[:, 0:2 * M:2], f[:, 1:2 * M:2], f[:, 2:2 * M + 1:2]
    s = xo - xe - h6 * (fe + 4.0 * fm + fo)
    m = xm - 0.5 * (xe + xo) - h8 * (fe - fo)
    if rfd is None:
        a, b = s, m
    else:
        a, b = rfd[0:2 * M:2] * s, rfd[1:2 * M:2] * m
    zero = torch.zeros_like(a[:, :1])
    ap, ac = torch.cat([zero, a], dim=1), torch.cat([a, zero], dim=1)
    bp, bc = torch.cat([zero, b], dim=1), torch.cat([b, zero], dim=1)
    v = h6 * (ap + ac) + h8 * (bc - bp)
    gX = torch.zeros_like(X)
    jt_e, pb_e = vjp(X[:, 0:2 * M + 1:2], v, slice(0, 2 * M + 1, 2))
    gX[:, 0:2 * M + 1:2] = ap - ac - 0.5 * (bp + bc) - jt_e
    jt_m, pb_m = vjp(xm, a, slice(1, 2 * M, 2))
    gX[:, 1:2 * M:2] = b - h23 * jt_m
    pg = None if pb_e is None else (torch.sum(pb_e, dim=1)
                                    + h23 * torch.sum(pb_m, dim=1))
    return a * s, torch.sum(a, dim=(1, 2)), h, gX, b * m, pg


def ag_reference(XP, rf, c: AgConsts, compensated=False):
    """Plain PyTorch action and gradient with the kernels' hand adjoint,
    under ``c.disc`` at a scalar or (N_f-1, D) ``rf``: K1's, K4's, K5's
    and the evaluation of K2/K3. ``XP`` (B, n_dof) -> (A (B,), dA/dXP (B,
    n_dof)); with ``compensated`` also K4's row (B, 6): the two-float sums
    [me_hi, me_lo, fe1_hi, fe1_lo, fe2_hi, fe2_lo] of the ME terms
    (W·diff)·diff, of the FE terms (r·r under a scalar rf, (w·r)·r under an
    (N_f-1, D) one; Hermite–Simpson's Simpson plane) and of the Hermite
    plane (zero under a one-step rule), by ``ops.action.comp_sum_pair``.
    Lorenz-96's F gradient is -2c k Σ q (∂f/∂F = 1); a row-level model's
    estimated parameters take the parameter adjoint summed over the
    rule's nodes (:func:`_onestep_terms`, :func:`_sh_terms`)."""
    B = XP.shape[0]
    dt = XP.dtype
    rf_s, rfd = _rf_arg(rf, c)
    X = XP[:, : c.n_state].reshape(B, c.N, c.D)
    h = _scalar(c.h, dt)
    hh = _scalar(h / 2.0, dt)
    me_norm = _scalar(c.me_norm, dt)
    fe_norm = _scalar(c.fe_norm, dt)

    if c.model == "l96":
        F = (XP[:, c.pslot].reshape(B, 1, 1) if c.pslot >= 0
             else _scalar(c.F_fixed, dt))
        f = rowmodel.l96_f(X, F)

        def vjp(rows, v, sl):
            return rowmodel.l96_jtv(rows, v), None
    else:
        P = rowmodel.full_params(XP[:, c.n_state:], c)
        f = rowmodel.f_rows(X, P, c)

        def vjp(rows, v, sl):
            return rowmodel.row_vjp(rows, P, v, c, sl)
    if c.disc == "SimpsonHermite":
        t1, sq, kF, gX, t2, pg = _sh_terms(X, f, rfd, c, h, vjp)
        fe = torch.sum(t1, dim=(1, 2)) + torch.sum(t2, dim=(1, 2))
    else:
        t1, sq, kF, gX, t2, pg = _onestep_terms(X, f, rfd, c, h, hh, vjp)
        fe = torch.sum(t1, dim=(1, 2))
    diff, me = measurement_error(X, c)
    if rfd is None:
        rf_s = _scalar(rf_s, dt)
        A = me + fe_norm * (rf_s * fe)
        c2 = 2.0 * fe_norm * rf_s
    else:
        A = me + fe_norm * fe
        c2 = 2.0 * fe_norm
    gX = c2 * gX
    gX[:, c.obs_rows[:, None], c.lidx.long()[None, :]] += (
        2.0 * me_norm * c.W * diff)
    parts = [gX.reshape(B, c.n_state)]
    if c.pslot >= 0:
        parts.append((-c2 * kF * sq)[:, None])
    elif c.pidx:
        parts.append(-c2 * pg.index_select(1, c.pidx_t))
    G = torch.cat(parts, dim=1)
    if not compensated:
        return A, G
    me_hi, me_lo = _action.comp_sum_pair(c.W * diff * diff, 2)
    fe_hi, fe_lo = _action.comp_sum_pair(t1, 2)
    if t2 is None:
        f2_hi = f2_lo = torch.zeros_like(me_hi)
    else:
        f2_hi, f2_lo = _action.comp_sum_pair(t2, 2)
    return A, G, torch.stack([me_hi, me_lo, fe_hi, fe_lo, f2_hi, f2_lo],
                             dim=1)


def combine(C, rf, c: AgConsts):
    """The compensated action from K4's rows ``C`` (B, 6), the reference's
    ``_combine``: me = (c0 + c1)·me_norm, fe = c2 + c3 + c4 + c5, times rf
    for a scalar rf (an (N_f-1, D) rf's weights are in the terms already),
    A = me + fe·fe_norm, in ``ops.action.combine_dtype`` of C's dtype, rf
    rounded to C's dtype first as the kernel receives it."""
    dt = _action.combine_dtype(C.dtype)
    C = C.to(dt)
    me = (C[:, 0] + C[:, 1]) * c.me_norm
    fe = C[:, 2] + C[:, 3] + C[:, 4] + C[:, 5]
    if np.ndim(rf) == 0:
        fe = _scalar(rf, C.dtype) * fe
    return me + fe * c.fe_norm


def _lib():
    from varanneal_tpu_torch.kernels import _build
    lib = _build.load("ag_kernel").lib
    if not getattr(lib, "_va_typed", False):
        P, I, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        args = [P, I, I, I, I, I, Dbl, P, P, P, P, I, I, I, Dbl, Dbl,
                Dbl, Dbl, P, P, P]
        for fn in (lib.va_l96_ag_trap_f32, lib.va_l96_ag_trap_f64):
            fn.restype = I
            fn.argtypes = args + [P]
        for fn in (lib.va_l96_ag_trap_comp_f32, lib.va_l96_ag_trap_comp_f64):
            fn.restype = I
            fn.argtypes = args + [P, P]
        lib.va_cuda_error_string.restype = ctypes.c_char_p
        lib.va_cuda_error_string.argtypes = [I]
        lib._va_typed = True
    return lib


def _rules_lib():
    from varanneal_tpu_torch.kernels import _build
    lib = _build.load("ag_rules_kernel").lib
    if not getattr(lib, "_va_typed", False):
        P, I, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        args = [P, I, I, I, I, I, Dbl, P, P, P, P, I, I, I, Dbl, Dbl,
                Dbl, Dbl, P, I, P, P, P]
        for fn in (lib.va_l96_ag_rule_f32, lib.va_l96_ag_rule_f64):
            fn.restype = I
            fn.argtypes = args + [P]
        for fn in (lib.va_l96_ag_rule_comp_f32, lib.va_l96_ag_rule_comp_f64):
            fn.restype = I
            fn.argtypes = args + [P, P]
        lib.va_cuda_error_string.restype = ctypes.c_char_p
        lib.va_cuda_error_string.argtypes = [I]
        lib._va_typed = True
    return lib


def _models_lib():
    from varanneal_tpu_torch.kernels import _build
    lib = _build.load("ag_models_kernel").lib
    if not getattr(lib, "_va_typed", False):
        P, I, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        args = [P, I] + ROW_ARGTYPES + [Dbl, P, P]
        for m in ROW_MODELS:
            for t in ("f32", "f64"):
                fn = getattr(lib, f"va_{m}_ag_{t}")
                fn.restype = I
                fn.argtypes = args + [P]
                fn = getattr(lib, f"va_{m}_ag_comp_{t}")
                fn.restype = I
                fn.argtypes = args + [P, P]
        lib.va_cuda_error_string.restype = ctypes.c_char_p
        lib.va_cuda_error_string.argtypes = [I]
        lib._va_typed = True
    return lib


#: The argument types of a row-level model's problem (VA_ROW_ARGS in
#: csrc/row_ag_block.cuh), as :func:`row_args` gives them.
ROW_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
    ctypes.c_int] * 3 + [ctypes.c_double] * 3 + [ctypes.c_int] + [
    ctypes.c_void_p] * 5 + [ctypes.c_int]


def row_args(c: AgConsts, rfd):
    """A row-level model's problem as the entries take it (VA_ROW_ARGS):
    n_dof, N, Y, W, lpos, N_data, L, obs_stride, h, me_norm, fe_norm,
    the rule, the (N_f-1, D) rf or NULL, the stimulus or NULL, the
    parameter row, each parameter's position among the estimated, the
    estimated parameters and their count."""
    return (c.n_dof, c.N, c.Y.data_ptr(), c.W.data_ptr(), c.lpos.data_ptr(),
            c.N_data, c.L, c.obs_stride, c.h, c.me_norm, c.fe_norm,
            DISCS[c.disc], None if rfd is None else rfd.data_ptr(),
            None if c.stim is None else c.stim.data_ptr(),
            c.P_lin.data_ptr(), c.pmap.data_ptr(), c.pidx_k.data_ptr(),
            len(c.pidx))


def model_key(model, disc, diag, compensated=False) -> str:
    """The key of :data:`MODEL_LAUNCHES` for one row-level model's entry."""
    return f"{model}/{rule_key(disc, diag, compensated)}"


def rule_key(disc, diag, compensated=False) -> str:
    """The key of :data:`RULE_LAUNCHES` for one rules' entry."""
    return (f"{disc}/{'diag' if diag else 'scalar'}"
            + ("/comp" if compensated else ""))


def ag_kernel(XP, rf, c: AgConsts, compensated=False):
    """Launch K1 (K4 when ``compensated``) on ``XP`` (B, n_dof), a
    contiguous CUDA tensor of ``c``'s dtype on ``c``'s device, at a scalar
    or (N_f-1, D) ``rf``: on Lorenz-96 the trapezoid rule with a scalar
    rf through ``csrc/ag_kernel.cu``, every other pair of ``c.disc`` and
    rf kind through ``csrc/ag_rules_kernel.cu``; a row-level model
    through ``csrc/ag_models_kernel.cu``. Returns (A, dA/dXP), and K4's
    (B, 6) row when ``compensated``, on PyTorch's current stream, without
    synchronizing. Raises on anything the kernel does not take and on a
    refused launch."""
    global LAUNCHES, COMP_LAUNCHES
    if c.disc not in DISCS:
        raise ValueError(f"K1 does not take disc {c.disc!r}")
    if XP.device.type != "cuda" or XP.device != c.device:
        raise ValueError(f"XP is on {XP.device}; the kernel's constants "
                         f"are on {c.device}")
    if XP.dtype != c.dtype or XP.ndim != 2 or XP.shape[1] != c.n_dof:
        raise ValueError(f"XP must be (B, {c.n_dof}) {c.dtype}; got "
                         f"{tuple(XP.shape)} {XP.dtype}")
    rf_s, rfd = _rf_arg(rf, c)
    rule = c.disc != "trapezoid" or rfd is not None
    XP = XP.contiguous()
    B = XP.shape[0]
    A = torch.empty(B, dtype=c.dtype, device=XP.device)
    G = torch.empty_like(XP)
    C = (torch.empty(B, 6, dtype=c.dtype, device=XP.device) if compensated
         else None)
    if B == 0:
        return (A, G, C) if compensated else (A, G)
    if c.model != "l96":
        return _row_kernel(XP, rf_s, rfd, c, A, G, C)
    lib = _rules_lib() if rule else _lib()
    f32 = c.dtype == torch.float32
    # the rings in a workspace where they do not fit on chip (NULL: there)
    work = (None if ring_on_chip(c.D, c.dtype, compensated, rule)
            else torch.empty(B, ring_elems(c.D), dtype=c.dtype,
                             device=XP.device))
    outs = (A.data_ptr(), G.data_ptr()) + (
        (C.data_ptr(),) if compensated else ())
    if rule:
        fn = {(True, False): lib.va_l96_ag_rule_f32,
              (False, False): lib.va_l96_ag_rule_f64,
              (True, True): lib.va_l96_ag_rule_comp_f32,
              (False, True): lib.va_l96_ag_rule_comp_f64}[
                  (f32, bool(compensated))]
        extra = (DISCS[c.disc], None if rfd is None else rfd.data_ptr())
    else:
        fn = {(True, False): lib.va_l96_ag_trap_f32,
              (False, False): lib.va_l96_ag_trap_f64,
              (True, True): lib.va_l96_ag_trap_comp_f32,
              (False, True): lib.va_l96_ag_trap_comp_f64}[
                  (f32, bool(compensated))]
        extra = ()
    with torch.cuda.device(XP.device):
        stream = torch.cuda.current_stream(XP.device).cuda_stream
        rc = fn(XP.data_ptr(), B, c.n_dof, c.N, c.D, c.pslot, c.F_fixed,
                c.Y.data_ptr(), c.W.data_ptr(), c.lidx.data_ptr(),
                c.lpos.data_ptr(), c.N_data, c.L, c.obs_stride, c.h,
                rf_s, c.me_norm, c.fe_norm,
                None if work is None else work.data_ptr(), *extra, *outs,
                stream)
    if rc != 0:
        raise RuntimeError(
            f"ag kernel launch failed: cudaError {rc} "
            f"({lib.va_cuda_error_string(rc).decode()})")
    if rule:
        key = rule_key(c.disc, rfd is not None, compensated)
        RULE_LAUNCHES[key] = RULE_LAUNCHES.get(key, 0) + 1
    if compensated:
        COMP_LAUNCHES += 1
        return A, G, C
    LAUNCHES += 1
    return A, G


def _row_kernel(XP, rf_s, rfd, c: AgConsts, A, G, C):
    """K1/K4 on a row-level model (ag_kernel's launch for it)."""
    global LAUNCHES, COMP_LAUNCHES
    lib = _models_lib()
    comp = C is not None
    fn = getattr(lib, f"va_{c.model}_ag_{'comp_' if comp else ''}"
                 + ("f32" if c.dtype == torch.float32 else "f64"))
    outs = (A.data_ptr(), G.data_ptr()) + ((C.data_ptr(),) if comp else ())
    with torch.cuda.device(XP.device):
        stream = torch.cuda.current_stream(XP.device).cuda_stream
        rc = fn(XP.data_ptr(), XP.shape[0], *row_args(c, rfd), rf_s,
                *outs, stream)
    if rc != 0:
        raise RuntimeError(
            f"ag kernel launch failed: cudaError {rc} "
            f"({lib.va_cuda_error_string(rc).decode()})")
    key = model_key(c.model, c.disc, rfd is not None, comp)
    MODEL_LAUNCHES[key] = MODEL_LAUNCHES.get(key, 0) + 1
    if comp:
        COMP_LAUNCHES += 1
        return A, G, C
    LAUNCHES += 1
    return A, G


def action_and_grad(XP, rf, c: AgConsts, compensated=False):
    """(A, dA/dXP) for ``XP`` (..., n_dof): the plain version for a CPU
    tensor, the kernel for a CUDA tensor. ``compensated``: K4, and A is
    the combined value (:func:`combine`), the gradient K1's."""
    lead = tuple(XP.shape[:-1])
    XP2 = XP.reshape(-1, c.n_dof)
    if XP.device.type == "cpu":
        if XP.device != c.device:
            raise ValueError(f"XP is on {XP.device}; the constants are on "
                             f"{c.device}")
        out = ag_reference(XP2, rf, c, compensated)
    else:
        out = ag_kernel(XP2, rf, c, compensated)
    A, G = out[0], out[1]
    if compensated:
        A = combine(out[2], rf, c)
    return A.reshape(lead), G.reshape(lead + (c.n_dof,))


class _AgAction(torch.autograd.Function):
    """The action with the kernel's gradient saved by the forward (``vag``
    gives both in one launch); the backward only scales it, the incoming
    gradient cast to the kernel's dtype first (``ag_pallas.py``'s
    ``action_bwd``). rf gets no gradient, as in the reference."""

    @staticmethod
    def forward(ctx, XP, rf, vag):
        A, G = vag(XP, rf)
        ctx.save_for_backward(G)
        return A

    @staticmethod
    def backward(ctx, gA):
        (G,) = ctx.saved_tensors
        return gA.to(G.dtype)[..., None] * G, None, None


def make_action_ag(spec: ProblemSpec, device=None, dtype=torch.float32,
                   compensated=False):
    """Build ``(action, action_parts)`` with the fused kernel.
    ``action(XP, rf)`` is differentiable by autograd and carries
    ``action.value_and_grad(XP, rf) -> (A, dA/dXP)``, one launch for both,
    which the solver calls directly. ``action_parts`` is the plain action
    (``ops.action``), used once per rung for the records.
    ``compensated=True`` runs K4: the value is the compensated action's,
    in ``ops.action.combine_dtype(dtype)``, the gradient K1's; the records
    come from the compensated autograd action, as in the reference.
    ``device=None`` means the CUDA card. Raises ValueError outside
    :func:`ag_supported`."""
    device = resolve_device(device)
    comp = bool(compensated)
    c = ag_consts(spec, device, dtype, comp)

    def value_and_grad(XP, rf):
        return action_and_grad(XP, rf, c, comp)

    def action(XP, rf):
        return _AgAction.apply(XP, rf, value_and_grad)

    action.value_and_grad = value_and_grad
    action.consts = c
    _, parts = _action.make_action(spec, device=device, compensated=comp)
    return action, parts


# ---------------------------------------------------------------------------
# K5: the one-step action at small D (make_action_ag_t)
# ---------------------------------------------------------------------------

def _agt_lib():
    from varanneal_tpu_torch.kernels import _build
    lib = _build.load("agt_kernel").lib
    if not getattr(lib, "_va_typed", False):
        P, I, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.va_l96_agt_f32, lib.va_l96_agt_f64):
            fn.restype = I
            fn.argtypes = [P, I, I, I, I, I, Dbl, P, P, P, P, I, I, I, Dbl,
                           Dbl, Dbl, I, Dbl, P, P, P, P]
        lib.va_cuda_error_string.restype = ctypes.c_char_p
        lib.va_cuda_error_string.argtypes = [I]
        lib._va_typed = True
    return lib


def agt_kernel(XP, rf, c: AgConsts):
    """Launch K5 on ``XP`` (B, n_dof), a contiguous CUDA tensor of ``c``'s
    dtype on ``c``'s device, at a scalar or (N_f-1, D) rf. Returns
    (A, dA/dXP) on PyTorch's current stream, without synchronizing.
    Raises on anything the kernel does not take and on a refused
    launch."""
    global AGT_LAUNCHES
    if c.disc not in AGT_DISCS:
        raise ValueError(f"K5 does not take disc {c.disc!r}")
    if XP.device.type != "cuda" or XP.device != c.device:
        raise ValueError(f"XP is on {XP.device}; the kernel's constants "
                         f"are on {c.device}")
    if XP.dtype != c.dtype or XP.ndim != 2 or XP.shape[1] != c.n_dof:
        raise ValueError(f"XP must be (B, {c.n_dof}) {c.dtype}; got "
                         f"{tuple(XP.shape)} {XP.dtype}")
    rf_s, rfd = _rf_arg(rf, c)
    XP = XP.contiguous()
    B = XP.shape[0]
    A = torch.empty(B, dtype=c.dtype, device=XP.device)
    G = torch.empty_like(XP)
    if B == 0:
        return A, G
    lib = _agt_lib()
    fn = lib.va_l96_agt_f32 if c.dtype == torch.float32 else \
        lib.va_l96_agt_f64
    with torch.cuda.device(XP.device):
        stream = torch.cuda.current_stream(XP.device).cuda_stream
        rc = fn(XP.data_ptr(), B, c.n_dof, c.N, c.D, c.pslot, c.F_fixed,
                c.Y.data_ptr(), c.W.data_ptr(), c.lidx.data_ptr(),
                c.lpos.data_ptr(), c.N_data, c.L, c.obs_stride, c.h,
                c.me_norm, c.fe_norm, AGT_DISCS[c.disc], rf_s,
                None if rfd is None else rfd.data_ptr(), A.data_ptr(),
                G.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"K5 launch failed: cudaError {rc} "
            f"({lib.va_cuda_error_string(rc).decode()})")
    AGT_LAUNCHES += 1
    return A, G


def action_and_grad_t(XP, rf, c: AgConsts):
    """(A, dA/dXP) for ``XP`` (..., n_dof) through K5: the plain version
    for a CPU tensor, the kernel for a CUDA tensor."""
    lead = tuple(XP.shape[:-1])
    XP2 = XP.reshape(-1, c.n_dof)
    if XP.device.type == "cpu":
        if XP.device != c.device:
            raise ValueError(f"XP is on {XP.device}; the constants are on "
                             f"{c.device}")
        A, G = ag_reference(XP2, rf, c)
    else:
        A, G = agt_kernel(XP2, rf, c)
    return A.reshape(lead), G.reshape(lead + (c.n_dof,))


def make_action_ag_t(spec: ProblemSpec, device=None, dtype=torch.float32):
    """Build ``(action, action_parts)`` with K5, the counterpart of the
    reference's ``make_action_ag_t`` and with :func:`make_action_ag`'s
    contract: ``action(XP, rf)`` is differentiable by autograd and carries
    ``action.value_and_grad(XP, rf) -> (A, dA/dXP)``, one launch for both,
    and ``action.consts``; ``action_parts`` is the plain action
    (``ops.action``) for the records. rf is a scalar or (N_f-1, D).
    ``device=None`` means the CUDA card. Raises ValueError outside
    :func:`agt_supported`, naming the condition (:func:`agt_refusal`)."""
    device = resolve_device(device)
    c = agt_consts(spec, device, dtype)

    def value_and_grad(XP, rf):
        return action_and_grad_t(XP, rf, c)

    def action(XP, rf):
        return _AgAction.apply(XP, rf, value_and_grad)

    action.value_and_grad = value_and_grad
    action.consts = c
    _, parts = _action.make_action(spec, device=device)
    return action, parts
