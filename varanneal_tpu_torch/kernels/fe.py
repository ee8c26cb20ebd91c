"""K6, the time-blocked model-error (FE) kernels, and the action engine
policy: which implementation of the action the facade, the runner and
the bench evaluate.

Counterpart of ``varanneal_tpu/kernels/fe_pallas.py`` (``fe_supported``,
``make_fe_pallas``, ``make_action_pallas``, ``pallas_preferred``,
``ag_preferred``, ``select_action``). Its seven ``pallas_call`` sites are
replaced on the card by the hand-written CUDA kernels of
``csrc/fe_kernel.cu`` (the source notes what bounds them and what their
design does about that):

- ``fe_onestep_fwd`` (K6a, ``_kern_scalar``/``_kern_diag``): per-block
  partial sums of rf ⊙ r² for euler, trapezoid and forwardmap;
- ``fe_onestep_vag`` (K6b ``_kern_bwd``, with K6a's value): the one-step
  value and gradient in one launch, fe_onestep_fwd's partials, the
  hand-written adjoint's gradient rows and the parameters' per-block
  partials;
- ``fe_sh_fwd`` (K6c ``_kern_sh_fwd`` and K6d, its batched-grid form):
  Hermite–Simpson's value over blocks of intervals;
- ``fe_sh_vag`` (K6c ``_kern_sh_bwd`` and K6d, its batched-grid form):
  Hermite–Simpson's value and gradient in one launch, fe_sh_fwd's
  partials and the backward as the (g_e0, g_m, g_e1) triplet that
  :func:`sh_join` adds into the gradient by node, as the reference does.

Every kernel runs on a (time block, member) grid, so B = 1 is K6c and
B > 1 is K6d. The kernels size their blocks from the batch's rows (B·M
intervals, B·N_f rows) and the card's SM count (:func:`rows_per_block`):
a thread takes one interval or row of a row-level model (NaKL, Colpitts,
Lorenz-63: each node's model evaluated once, reused by the residuals, Jᵀv and the parameter adjoint) or one
(interval or row, component) pair of Lorenz-96. A value-only launch and
the fused one share their blocks, so their value partials agree bit for
bit. The kernels take four models, each with f, Jᵀv and the
parameter adjoint written by hand: Lorenz-96 (``models.lorenz.lorenz96``),
NaKL (``models.nakl.nakl``, or a log-space model of
``models.nakl.nakl_log_model``; ``csrc/nakl.cuh``) with its stimulus,
Colpitts (``models.colpitts.colpitts``; ``csrc/colpitts.cuh``) and
Lorenz-63 (``models.lorenz.lorenz63``; ``csrc/l63.cuh``). NaKL, Colpitts
and Lorenz-63 are row-level models: a thread owns an interval or row.
The wrapper merges the estimated values into the fixed parameters
(:func:`full_params`, the reference's ``_merge``), exponentiates a log
model's coordinates before the launch and applies the chain rule to
their gradient after it, so a kernel always sees linear parameters.
Beside each kernel is its plain PyTorch version (``*_reference``), which
returns the same per-block partials: for Lorenz-96 it spells out the same
hand adjoint on ``torch.roll``, for a row-level model it evaluates the
port's torch model and takes the adjoint with ``torch.func.vjp``, a
derivation independent of the hand-written one. The CPU path and the tests use them,
and a wrapper takes its plain version only for tensors on the CPU: on a
CUDA tensor it launches its kernel or raises. Each wrapper counts its
launches (:data:`FWD_LAUNCHES`, :data:`ONESTEP_VAG_LAUNCHES`,
:data:`SH_FWD_LAUNCHES`, :data:`SH_VAG_LAUNCHES`).

:func:`make_fe_pallas` returns ``fe(X, pest, rf)``, a
``torch.autograd.Function`` whose forward is one launch and whose
backward is one launch (the fused one, its value unread), scaled by
2·g/norm as the reference's ``custom_vjp``, and ``fe.value_and_grad``,
the same value and gradient without autograd's graph (one fused
launch);
:func:`make_action_pallas` keeps ME in plain PyTorch and gives its
action a ``value_and_grad`` (ME's gradient in closed form), which every
ladder and solver loop takes (``ops.action.value_and_grad``).

The engines of :func:`select_action`:

- ``'xla'``: the autograd action (``ops.action.make_action``);
- ``'ag'``: K1, the fused action+gradient kernel
  (``kernels.ag.make_action_ag``), forced; ValueError outside its
  envelope;
- ``'pallas'``: K6 (:func:`make_action_pallas`), forced; ValueError where
  the reference's :func:`fe_supported` fails, NotImplementedError where
  the reference runs K6 but the port's envelope
  (:func:`fe_kernel_supported`) does not hold;
- ``'auto'``: the reference's split. Inside its measured-win regime (the
  card, float32, a one-step disc, D >= 256): K1 wherever the reference's
  ``ag_supported`` holds (:func:`reference_ag_supported`), else K6 where
  :func:`pallas_preferred` holds, each raising NotImplementedError where
  the port's kernel does not cover the problem yet; the autograd action
  everywhere else. No kernel is quietly replaced by another.
"""

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.kernels import ag
from varanneal_tpu_torch.kernels.rowmodel import (
    MODEL_NP, MODEL_NPX, f_rows, full_params, l96_jtv, model_of, param_grad,
    param_rows, pest_grad, row_model_refusal, row_vjp)
from varanneal_tpu_torch.ops import action as _action
from varanneal_tpu_torch.ops.spec import ProblemSpec

#: The reference's threshold for ``engine='auto'`` (``_AUTO_MIN_D``):
#: its Pallas engines won from D = 256 on, and lost below.
AUTO_MIN_D = 256
_ONE_STEP = ("euler", "trapezoid", "forwardmap")
_DISCS = _ONE_STEP + ("SimpsonHermite",)
_DISC_CODE = {"euler": 0, "trapezoid": 1, "forwardmap": 2}
#: The kernels' models (``ModelId`` in csrc/fe_kernel.cu); their
#: parameter counts are ``rowmodel.MODEL_NP``.
_MODEL_CODE = {"l96": 0, "nakl": 1, "colpitts": 2, "l63": 3}
_DTYPES = (torch.float32, torch.float64)

#: Launches so far of fe_onestep_fwd (K6a), fe_onestep_vag (K6b with
#: K6a's value in one launch), fe_sh_fwd and fe_sh_vag (K6c/K6d:
#: Hermite–Simpson's value, and its value and gradient in one launch);
#: each successful launch adds one.
FWD_LAUNCHES = 0
ONESTEP_VAG_LAUNCHES = 0
SH_FWD_LAUNCHES = 0
SH_VAG_LAUNCHES = 0

#: The grid (:func:`rows_per_block`, :func:`sh_threads`,
#: :func:`onestep_threads`): blocks an SM the rule aims at, the card's SM
#: count where no card is asked (an H100's), and per model the most
#: threads a block runs (at most the kernel's launch bound,
#: ``kMaxThreads`` in csrc/fe_kernel.cu, which refuses more), whether a
#: thread owns an interval or row (row-level, ``kRow``); the parameter
#: row a block stages is ``rowmodel.MODEL_NPX``'s (``kNPX``; the
#: envelope's shared memory).
BLOCKS_PER_SM = 2
DEFAULT_SMS = 132
_MAX_THREADS = {"l96": 1024, "nakl": 256, "colpitts": 256, "l63": 256}
_ROW_MODEL = {"l96": False, "nakl": True, "colpitts": True, "l63": True}
#: Lorenz-96's (interval or row, component) pairs a block takes at most,
#: where D allows more than one.
_MAX_PAIRS = 256
#: Rows a one-step warp of a row-level model owns (``kWarpRows``): its
#: 32 lanes hold those rows' nodes and the two halo nodes beside them.
ONESTEP_WARP_ROWS = 30


# ---------------------------------------------------------------------------
# predicates: the reference's and the port's envelope
# ---------------------------------------------------------------------------

def _grid_dt(spec: ProblemSpec) -> float:
    """Model-grid row spacing: dt for one-step discs, dt/2 under
    Hermite–Simpson (the doubled grid)."""
    return spec.dt / 2.0 if spec.disc == "SimpsonHermite" else spec.dt


def _uniform_grid(spec: ProblemSpec) -> bool:
    t_f = np.asarray(spec.t_f)
    ref = t_f[0] + _grid_dt(spec) * np.arange(t_f.shape[0])
    return bool(np.allclose(t_f, ref, rtol=1e-12, atol=1e-9))


def fe_supported(spec: ProblemSpec, rf) -> bool:
    """The reference's predicate (``fe_pallas.fe_supported``): any of the
    four discs, constant parameters, scalar or (N_f-1, D) rf, a uniform
    grid."""
    return (spec.disc in _DISCS
            and not spec.time_dep_p
            and np.ndim(rf) in (0, 2)
            and _uniform_grid(spec))


def _pad_to(v, mult):
    return -(-v // mult) * mult


def reference_ag_supported(spec: ProblemSpec, rf,
                           dtype=torch.float32) -> bool:
    """The reference's K1 predicate (``ag_pallas.ag_supported``): any of
    the four discs, constant parameters, float32, scalar or (N_f-1, D) rf,
    scalar or (N_data, L) RM, a uniform grid, and the padded state
    (rows to 8, components to 128 lanes) at most 2²¹ values. Where it
    holds, the reference's ``engine='auto'`` takes K1 inside the regime."""
    return (spec.disc in _DISCS
            and not spec.time_dep_p
            and dtype == torch.float32
            and np.ndim(rf) in (0, 2)
            and np.ndim(spec.RM) in (0, 2)
            and _uniform_grid(spec)
            and _pad_to(spec.N_f, 8) * _pad_to(spec.D, 128) <= 2 ** 21)


def sh_threads(model: str, bk: int, D: int) -> int:
    """Threads a Hermite–Simpson block of ``bk`` intervals runs (the
    launch takes it; the kernels stride by it): one interval a thread for
    a row-level model, one (interval, component) pair for Lorenz-96, in
    whole warps, at most the model's ``kMaxThreads``."""
    want = bk if _ROW_MODEL[model] else bk * D
    return min(_pad_to(want, 32), _MAX_THREADS[model])


def onestep_threads(model: str, bn: int, D: int) -> int:
    """Threads a one-step block of ``bn`` rows runs: a warp a
    :data:`ONESTEP_WARP_ROWS` rows of a row-level model (its lanes the
    rows' nodes and the two halo nodes), for Lorenz-96 one (row,
    component) pair of the bn + 1 rows of weighted residuals (the halo row
    the first), in whole warps, at most the model's ``kMaxThreads`` (past
    which a thread takes more pairs)."""
    if _ROW_MODEL[model]:
        return 32 * -(-bn // ONESTEP_WARP_ROWS)
    return min(_pad_to((bn + 1) * D, 32), _MAX_THREADS[model])


def _smem_bytes(kernel: str, bn: int, D: int, dtype, model="l96") -> int:
    """Bytes of shared memory a block of ``kernel`` takes at ``bn`` rows
    (intervals under Hermite–Simpson) a block, as the launch in
    csrc/fe_kernel.cu sizes it (``onestep_smem_vals``,
    ``sh_smem_vals``), for the envelope (:func:`fe_refusal`): kNP + 1
    slots a warp of the block's threads, a row model's extended parameter
    row and, under Hermite–Simpson, its stimulus; Lorenz-96's staged rows
    (one-step: 2bn + 3 rows of x and weighted residuals; Hermite–Simpson:
    2bn + 1 rows of x, and S, H, v0, vm and v1 in the fused launch)."""
    NP = MODEL_NP[model]
    if kernel in ("sh_fwd", "sh_vag"):
        vals = (2 * bn + 1) * D + sh_threads(model, bn, D) // 32 * (NP + 1)
        if _ROW_MODEL[model]:
            vals += MODEL_NPX[model] + 2 * bn + 1
        elif kernel == "sh_vag":
            vals += 5 * bn * D
    else:
        vals = onestep_threads(model, bn, D) // 32 * (NP + 1)
        vals += MODEL_NPX[model] if _ROW_MODEL[model] else (2 * bn + 3) * D
    return vals * (torch.finfo(dtype).bits // 8)


def _kernels_of(disc):
    if disc == "SimpsonHermite":
        return ("sh_fwd", "sh_vag")
    return ("onestep_fwd", "onestep_vag")


def rows_per_block(kernel: str, n_rows: int, D: int, block_n: int,
                   model="l96", B: int = 1, n_sm: int = DEFAULT_SMS) -> int:
    """Rows (intervals under Hermite–Simpson) a block of ``kernel`` takes,
    one rule for a disc's value-only launch and its fused one, so that
    their value partials share the blocks. ``n_rows``: M intervals under
    Hermite–Simpson, N_f gradient rows for a one-step disc.

    From the batch's B·n_rows and the card's ``n_sm``: ``want`` =
    ceil(B·n_rows / (:data:`BLOCKS_PER_SM` · n_sm)) a block, so that
    even one member covers the SMs. Lorenz-96 takes ``want`` but at most
    256 // D (256 pairs a block, one from D = 129 on). A row-level model
    (NaKL, Colpitts, Lorenz-63) rounds ``want`` up to whole warps: under Hermite–Simpson 32
    intervals a warp, between 32 and its 256 threads; for a one-step disc
    :data:`ONESTEP_WARP_ROWS` rows a warp, between one warp and eight.
    Either way at most ``block_n`` and ``n_rows``. So a thread takes one
    interval or row (a row-level model) or one pair (Lorenz-96 up to D = 1,024 under
    Hermite–Simpson, 512 one-step: :func:`sh_threads`,
    :func:`onestep_threads`), and the staged rows of Lorenz-96's
    one-interval or one-row block bound its D
    (:func:`fe_kernel_supported`). The dtype sizes nothing: a block's
    shared memory stays under the card's at every width the envelope
    takes. The partition depends on B: a member's value and parameter
    partials are summed in another order at another batch size (its
    gradient rows are not sums and do not move)."""
    want = -(-int(B) * n_rows // (BLOCKS_PER_SM * int(n_sm)))
    if not _ROW_MODEL[model]:
        bk = max(1, min(want, _MAX_PAIRS // D))
    elif kernel in ("sh_fwd", "sh_vag"):
        bk = min(_MAX_THREADS[model], max(32, _pad_to(want, 32)))
    else:
        per = ONESTEP_WARP_ROWS
        bk = min(per * (_MAX_THREADS[model] // 32),
                 max(per, -(-want // per) * per))
    return max(1, min(bk, int(block_n), n_rows))


def fe_refusal(spec: ProblemSpec, rf=0.0, dtype=torch.float32):
    """Why the port's K6 does not take this problem (the condition named),
    or None where it does (:func:`fe_kernel_supported`)."""
    m = model_of(spec.f)
    if m is None:
        return ("the model is neither Lorenz-96 (models.lorenz96), NaKL "
                "(models.nakl or a model of models.nakl_log_model), Colpitts "
                "(models.colpitts) nor Lorenz-63 (models.lorenz63)")
    model, log_idx = m
    if model == "l96":
        if spec.D < 4:
            return f"Lorenz-96 with D = {spec.D} < 4"
        if spec.stim_f is not None:
            return "Lorenz-96 with a stimulus"
        if spec.NP != 1 or spec.pidx not in ((), (0,)):
            return (f"Lorenz-96 with NP = {spec.NP}, pidx {spec.pidx} (the "
                    "kernels take p = [F])")
    else:
        why = row_model_refusal(spec, model, log_idx)
        if why is not None:
            return why
    if spec.time_dep_p:
        return "time-dependent parameters"
    if spec.disc not in _DISCS:
        return f"disc {spec.disc!r}"
    if spec.disc == "SimpsonHermite" and spec.N_f % 2 != 1:
        return f"Hermite–Simpson with an even N_f = {spec.N_f}"
    rf_nd = np.ndim(rf)
    if rf_nd not in (0, 2) or (rf_nd == 2 and np.shape(rf) != (
            spec.N_f - 1, spec.D)):
        return (f"rf of shape {np.shape(rf)} (scalar or "
                f"({spec.N_f - 1}, {spec.D}))")
    if dtype not in _DTYPES:
        return f"dtype {dtype}"
    if not _uniform_grid(spec):
        return "a non-uniform time grid"
    if _smem_bytes(_kernels_of(spec.disc)[1], 1, spec.D, dtype,
                   model) > ag.SMEM_LIMIT:
        unit = "interval" if spec.disc == "SimpsonHermite" else "row"
        return (f"D = {spec.D}: one {unit} a block exceeds one block's "
                "shared memory")
    return None


def fe_kernel_supported(spec: ProblemSpec, rf=0.0,
                        dtype=torch.float32) -> bool:
    """The port's K6 envelope (:func:`fe_refusal` names what fails):

    - Lorenz-96 (``models.lorenz.lorenz96``, D >= 4) without a stimulus,
      NP == 1 with F estimated or fixed;
    - NaKL (``models.nakl.nakl`` or a model of ``nakl_log_model``, D = 4,
      NP = 19, any ``pidx``), with or without a stimulus (column 0 of an
      (N_f, S) ``stim_f``);
    - Colpitts (``models.colpitts.colpitts``, D = 3, NP = 4) and
      Lorenz-63 (``models.lorenz.lorenz63``, D = 3, NP = 3), any distinct
      ``pidx``, without a stimulus;

    and for both: constant parameters, any of the four discs, scalar or
    (N_f-1, D) rf, a uniform grid, float32 or float64, and the smallest
    block of the disc's fused launch within one block's shared memory
    (``ag.SMEM_LIMIT``): for Lorenz-96 under Hermite–Simpson one interval
    a block (8 rows of D), D up to 3,624 in float64 and 7,256 in float32;
    for the one-step discs one row a block (5 rows of D), D up to 5,798
    and 11,609."""
    return fe_refusal(spec, rf, dtype) is None


def _in_regime(spec: ProblemSpec, dtype, device) -> bool:
    return (resolve_device(device).type == "cuda"
            and dtype == torch.float32
            and spec.disc in _ONE_STEP
            and spec.D >= AUTO_MIN_D)


def ag_preferred(spec: ProblemSpec, rf, dtype=torch.float32,
                 device=None) -> bool:
    """The reference's ``ag_preferred``: ``engine='auto'`` takes K1 (the
    regime: a one-step disc, D >= :data:`AUTO_MIN_D`, float32, on the
    card; and :func:`reference_ag_supported`)."""
    return (_in_regime(spec, dtype, device)
            and reference_ag_supported(spec, rf, dtype))


def pallas_preferred(spec: ProblemSpec, rf, dtype=torch.float32,
                     device=None) -> bool:
    """The reference's ``pallas_preferred`` (``fe_pallas.py:892-909``):
    the regime and :func:`fe_supported`. Hermite–Simpson stays opt-in,
    as does everything off the card."""
    return _in_regime(spec, dtype, device) and fe_supported(spec, rf)


def _k6_waits(spec: ProblemSpec, rf, dtype):
    return NotImplementedError(
        "the time-blocked FE kernels K6 do not take this problem: "
        f"{fe_refusal(spec, rf, dtype)} (kernels.fe.fe_kernel_supported); "
        "the reference runs K6 here, which waits for a later slice of the "
        "port: see ROADMAP.md, §2a item 3 (user models: a hand-written f, "
        "Jᵀv and parameter adjoint each)")


def select_action(spec: ProblemSpec, rf, engine: str = "auto",
                  dtype=torch.float32, device=None, block_n: int = 64,
                  pallas_backward: bool = True):
    """``(action, action_parts)`` of the chosen engine (see the module
    docstring), with ``action.engine`` set to the engine taken.
    ``block_n``/``pallas_backward``: K6's, as the reference's
    ``select_action`` passes them. ``device=None`` means the CUDA card."""
    if engine not in ("auto", "xla", "pallas", "ag"):
        raise ValueError(
            f"engine must be auto/xla/pallas/ag, got {engine!r}")
    device = resolve_device(device)
    if engine == "pallas" and not fe_supported(spec, rf):
        raise ValueError(
            "engine='pallas' unsupported for this problem (time-dependent "
            "parameters / rf rank / non-uniform grid; see "
            "kernels.fe.fe_supported)")
    why = ag.ag_refusal(spec, rf, dtype)
    if engine == "ag" and why is not None:
        raise ValueError(
            f"engine='ag' unsupported for this problem: {why} (see "
            "kernels.ag.ag_supported)")
    if engine == "auto":
        if ag_preferred(spec, rf, dtype, device):
            if why is not None:
                raise NotImplementedError(
                    "engine='auto' at D >= 256 in float32 on the card: the "
                    "reference runs its whole-problem kernel K1 here, and "
                    f"the port's K1 refuses this problem: {why}. Its "
                    "widening waits for a later slice: see ROADMAP.md §2a "
                    "item 2; pass engine='xla' for the autograd action")
            engine = "ag"
        elif pallas_preferred(spec, rf, dtype, device):
            engine = "pallas"
    if engine == "pallas" and not fe_kernel_supported(spec, rf, dtype):
        raise _k6_waits(spec, rf, dtype)
    if engine == "ag":
        act, parts = ag.make_action_ag(spec, device=device, dtype=dtype)
    elif engine == "pallas":
        act, parts = make_action_pallas(spec, block_n=block_n,
                                        pallas_backward=pallas_backward,
                                        device=device)
    else:
        act, parts = _action.make_action(spec, device=device)
        engine = "xla"
    act.engine = engine
    return act, parts


# ---------------------------------------------------------------------------
# the kernels' constants and their plain PyTorch versions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FeConsts:
    """K6's constants for one problem, dtype and device. A block's rows
    follow the batch size (:meth:`rows`); ``block_n`` caps them, ``n_sm``
    is the card's SM count (:data:`DEFAULT_SMS` off the card). ``P_base`` holds the full
    parameter vector on the estimation scale (log coordinates logged).
    The tensors, made once on ``device`` by :func:`fe_consts`: ``P_lin``
    the (NP,) parameters on the linear scale (log coordinates
    exponentiated), ``stim`` the (N_f,) injected current or None,
    ``pidx_t`` the estimated indices, ``log_mask`` (NP,) and ``pest_log``
    (NPest,) the log coordinates (None without any)."""
    disc: str
    N_f: int
    D: int
    M: int                  # Hermite–Simpson intervals, (N_f - 1) // 2
    model: str              # 'l96', 'nakl', 'colpitts' or 'l63'
    pidx: tuple             # estimated parameters (indices into NP)
    log_idx: tuple          # coordinates estimated in log space
    P_base: tuple           # (NP,) floats
    h: float
    norm: float             # D · (N_f - 1)
    block_n: int
    n_sm: int
    dtype: torch.dtype
    device: torch.device
    P_lin: torch.Tensor = dataclasses.field(compare=False, repr=False)
    stim: Optional[torch.Tensor] = dataclasses.field(compare=False,
                                                     repr=False)
    pidx_t: torch.Tensor = dataclasses.field(compare=False, repr=False)
    log_mask: Optional[torch.Tensor] = dataclasses.field(compare=False,
                                                         repr=False)
    pest_log: Optional[torch.Tensor] = dataclasses.field(compare=False,
                                                         repr=False)

    @property
    def sh(self) -> bool:
        return self.disc == "SimpsonHermite"

    @property
    def NP(self) -> int:
        return len(self.P_base)

    @property
    def direct(self) -> bool:
        """Whether the estimated values are the parameter rows themselves
        (every parameter estimated, in order, none in log space): the
        kernels then read ``pest`` with no merge."""
        return self.pidx == tuple(range(self.NP)) and not self.log_idx

    def rows(self, B: int = 1) -> int:
        """Rows (intervals under Hermite–Simpson) a block of the disc's
        launches at batch size B, :func:`rows_per_block`'s rule: the
        value-only and the fused launch share one partition."""
        kernel = "sh_vag" if self.sh else "onestep_vag"
        return rows_per_block(kernel, self.M if self.sh else self.N_f,
                              self.D, self.block_n, self.model, B,
                              self.n_sm)

    def n_blocks(self, B: int = 1) -> int:
        """Blocks a member of the disc's launches at batch size B: their
        partials' last axis (a one-step disc's N_f gradient rows over
        :meth:`rows`; the residual rows are one fewer, so the last block
        may hold none and its value partial is 0)."""
        return -(-(self.M if self.sh else self.N_f) // self.rows(B))

    def coeffs(self):
        """The disc's constants as the reference forms them, each a Python
        float: (hc, a1, c0, c1) for a one-step disc (hc = h/2 for the
        trapezoid rule, h for euler; ``_disc_coeffs``), (h/6, h/8, 4h/6)
        under Hermite–Simpson."""
        h = self.h
        if self.sh:
            return h / 6.0, h / 8.0, 4.0 * h / 6.0
        if self.disc == "trapezoid":
            return h / 2.0, 1.0, h / 2.0, h / 2.0
        if self.disc == "euler":
            return h, 1.0, 0.0, h
        return 0.0, 0.0, 0.0, 1.0           # forwardmap


def fe_consts(spec: ProblemSpec, dtype, device, block_n: int = 512
              ) -> FeConsts:
    """:class:`FeConsts` for ``spec`` (which must lie in
    :func:`fe_kernel_supported` for ``dtype``), its tensors on
    ``device``."""
    why = fe_refusal(spec, 0.0, dtype)
    if why is not None:
        raise ValueError(f"problem outside K6's envelope: {why} (see "
                         "kernels.fe.fe_kernel_supported); use "
                         "ops.action.make_action")
    model, log_idx = model_of(spec.f)
    device = resolve_device(device)
    sh = spec.disc == "SimpsonHermite"
    M = (spec.N_f - 1) // 2 if sh else 0
    n_sm = (torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else DEFAULT_SMS)
    P_base = tuple(float(v) for v in np.asarray(spec.P_base))
    pidx, log_idx = tuple(spec.pidx), tuple(log_idx)

    def on_dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    log_mask = pest_log = None
    P_lin = on_dev(np.asarray(P_base, np.float64))
    if log_idx:
        log_mask = on_dev([j in log_idx for j in range(len(P_base))],
                          torch.bool)
        P_lin = torch.where(log_mask, torch.exp(P_lin), P_lin)
        if any(j in log_idx for j in pidx):
            pest_log = on_dev([j in log_idx for j in pidx], torch.bool)
    return FeConsts(
        disc=spec.disc, N_f=spec.N_f, D=spec.D, M=M, model=model,
        pidx=pidx, log_idx=log_idx, P_base=P_base, h=float(spec.dt),
        norm=spec.D * (spec.N_f - 1),
        block_n=int(block_n), n_sm=int(n_sm), dtype=dtype, device=device,
        P_lin=P_lin,
        stim=(None if spec.stim_f is None else on_dev(
            np.asarray(spec.stim_f, np.float64)[:, 0])),
        pidx_t=on_dev(np.asarray(pidx, np.int64), torch.long),
        log_mask=log_mask, pest_log=pest_log)


def _scalar(v, dtype):
    """A Python float rounded to ``dtype``, as the kernel receives it."""
    return float(torch.tensor(float(v), dtype=dtype))


def _block_sums(t, bn, nb=None):
    """(B, R, D) -> (B, nb): the sum over each block of bn rows, nb =
    ceil(R / bn) unless given (a block past the rows sums to 0)."""
    B, R, D = t.shape
    nb = -(-R // bn) if nb is None else nb
    if nb * bn > R:
        t = torch.cat([t, t.new_zeros(B, nb * bn - R, D)], dim=1)
    return t.reshape(B, nb, bn * D).sum(dim=2)


def _block_param_sums(pbar, bn):
    """(B, R, NP) row adjoints -> (B, NP, ceil(R / bn)) per-block sums."""
    return torch.stack([_block_sums(pbar[..., j:j + 1], bn)
                        for j in range(pbar.shape[-1])], dim=1)


def _onestep_residuals(X, P, c: FeConsts):
    dt = X.dtype
    fX = f_rows(X, P, c)
    hc = _scalar(c.coeffs()[0], dt)
    if c.disc == "trapezoid":
        return X[:, 1:] - X[:, :-1] - hc * (fX[:, :-1] + fX[:, 1:])
    if c.disc == "euler":
        return X[:, 1:] - X[:, :-1] - hc * fX[:, :-1]
    return X[:, 1:] - fX[:, :-1]


def _onestep_value(r, rf, c: FeConsts):
    """The weighted residuals wr = rf ⊙ r and the value's partials per
    block (B, c.n_blocks(B)) of rf·Σ r² (scalar rf) or Σ wr ⊙ r,
    summed as both one-step launches sum them."""
    B = r.shape[0]
    bn, nb = c.rows(B), c.n_blocks(B)
    if isinstance(rf, torch.Tensor):
        wr = rf * r
        return wr, _block_sums(wr * r, bn, nb)
    rf_s = _scalar(rf, r.dtype)
    return rf_s * r, rf_s * _block_sums(r * r, bn, nb)


def onestep_fwd_reference(X, pest, rf, c: FeConsts):
    """Plain version of fe_onestep_fwd: X (B, N_f, D), pest (B, NPest), rf
    a float or an (N_f-1, D) tensor -> partials (B, c.n_blocks(B))."""
    return _onestep_value(_onestep_residuals(X, full_params(pest, c), c),
                          rf, c)[1]


def onestep_vag_reference(X, pest, rf, c: FeConsts):
    """Plain version of the fused fe_onestep_vag, ``(partials, gx, gp)``,
    from one pass over the residuals: fe_onestep_fwd's partials (B,
    c.n_blocks(B)), the unscaled gradient rows gx_m = wr_{m-1} -
    a1 wr_m - J(x_m)ᵀ v_m (B, N_f, D), with wr the weighted residuals
    (zero before the first row and after the last) and v_m = c0 wr_{m-1}
    + c1 wr_m, and the parameters' partials -Σ_m F_p(x_m)ᵀ v_m per block
    of ``c.rows(B)`` rows (B, NP, blocks); for Lorenz-96, whose F
    has df_d/dF = 1, that is -(c0 + c1) Σ wr over the block's residual
    rows, as the kernel forms it."""
    dt = X.dtype
    _, a1, c0, c1 = (_scalar(v, dt) for v in c.coeffs())
    P = full_params(pest, c)
    wr, parts = _onestep_value(_onestep_residuals(X, P, c), rf, c)
    B = X.shape[0]
    bn = c.rows(B)
    z = torch.zeros_like(wr[:, :1])
    wr_prev = torch.cat([z, wr], dim=1)
    wr_cur = torch.cat([wr, z], dim=1)
    v = c0 * wr_prev + c1 * wr_cur
    if c.model == "l96":
        gx = wr_prev - a1 * wr_cur - l96_jtv(X, v)
        gF = -(c0 + c1) * _block_sums(wr, bn, c.n_blocks(B))
        return parts, gx, gF[:, None, :]
    jtv, pbar = row_vjp(X, P, v, c, slice(None))
    return (parts, wr_prev - a1 * wr_cur - jtv,
            -_block_param_sums(pbar, bn))


def _sh_parts(X, P, rf, c: FeConsts):
    dt = X.dtype
    h6, h8, _ = (_scalar(v, dt) for v in c.coeffs())
    M = c.M
    fX = f_rows(X, P, c)
    xe0, xm, xe1 = X[:, 0:2 * M:2], X[:, 1:2 * M:2], X[:, 2:2 * M + 1:2]
    f0, fm, f1 = fX[:, 0:2 * M:2], fX[:, 1:2 * M:2], fX[:, 2:2 * M + 1:2]
    S = xe1 - xe0 - h6 * (f0 + 4.0 * fm + f1)
    H = xm - 0.5 * (xe0 + xe1) - h8 * (f0 - f1)
    if isinstance(rf, torch.Tensor):
        ws, wh = rf[0:2 * M:2], rf[1:2 * M:2]
    else:
        ws = wh = _scalar(rf, dt)
    return (xe0, xm, xe1), S, H, ws, wh


def sh_fwd_reference(X, pest, rf, c: FeConsts):
    """Plain version of fe_sh_fwd: partials Σ ws S² + wh H² per block of
    ``c.rows(B)`` intervals (B, ``c.n_blocks(B)``)."""
    _, S, H, ws, wh = _sh_parts(X, full_params(pest, c), rf, c)
    return _block_sums(ws * S * S + wh * H * H, c.rows(X.shape[0]))


def sh_vag_reference(X, pest, rf, c: FeConsts):
    """Plain version of the fused fe_sh_vag, ``(partials, g_e0, g_m, g_e1,
    gp)``: fe_sh_fwd's partials (B, ``c.n_blocks(B)``), the
    unscaled triplet, each (B, M, D), and the parameters' partials
    Σ (F_p0ᵀ v0 + F_pmᵀ vm + F_p1ᵀ v1) (B, NP, blocks), on blocks of
    ``c.rows(B)`` intervals."""
    dt = X.dtype
    bk = c.rows(X.shape[0])
    h6, h8, h46 = (_scalar(v, dt) for v in c.coeffs())
    P = full_params(pest, c)
    (xe0, xm, xe1), S, H, ws, wh = _sh_parts(X, P, rf, c)
    parts = _block_sums(ws * S * S + wh * H * H, bk)
    WS, WH = ws * S, wh * H
    v0 = -h6 * WS - h8 * WH
    vm = -h46 * WS
    v1 = -h6 * WS + h8 * WH
    if c.model == "l96":
        ge0 = -WS - 0.5 * WH + l96_jtv(xe0, v0)
        gm = WH + l96_jtv(xm, vm)
        ge1 = WS - 0.5 * WH + l96_jtv(xe1, v1)
        return parts, ge0, gm, ge1, _block_sums(v0 + vm + v1, bk)[:, None, :]
    M = c.M
    j0, p0 = row_vjp(xe0, P, v0, c, slice(0, 2 * M, 2))
    jm, pm = row_vjp(xm, P, vm, c, slice(1, 2 * M, 2))
    j1, p1 = row_vjp(xe1, P, v1, c, slice(2, 2 * M + 1, 2))
    return (parts, -WS - 0.5 * WH + j0, WH + jm, WS - 0.5 * WH + j1,
            _block_param_sums(p0 + pm + p1, bk))


def sh_join(ge0, gm, ge1, c: FeConsts):
    """The gradient rows (B, N_f, D) from the triplet: even node j gets
    g_e0[j] + g_e1[j-1], midpoint 2k+1 gets g_m[k] (the reference's
    shift-add, ``fe_pallas.py:664-670``)."""
    gx = ge0.new_empty(ge0.shape[0], c.N_f, c.D)
    ev = gx[:, 0::2]
    ev[:, :c.M] = ge0
    ev[:, c.M] = 0.0
    ev[:, 1:] += ge1
    gx[:, 1::2] = gm
    return gx


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _lib():
    from varanneal_tpu_torch.kernels import _build
    lib = _build.load("fe_kernel").lib
    if not getattr(lib, "_va_typed", False):
        P, I, LL, Dbl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
        common = [P, LL, P, LL, P, P, Dbl, I, I, I]
        for t in ("f32", "f64"):
            fn = getattr(lib, f"va_fe_onestep_fwd_{t}")
            fn.argtypes = [I, I, I] + common + [Dbl, I, I, P, P]
            fn = getattr(lib, f"va_fe_onestep_vag_{t}")
            fn.argtypes = [I, I, I] + common + [Dbl, Dbl, Dbl, Dbl, I, I, P,
                                                P, P, P]
            fn = getattr(lib, f"va_fe_sh_fwd_{t}")
            fn.argtypes = [I, I] + common + [Dbl, Dbl, I, I, P, P]
            fn = getattr(lib, f"va_fe_sh_vag_{t}")
            fn.argtypes = [I, I] + common + [Dbl, Dbl, Dbl, I, I, P, P, P, P,
                                             P, P]
            for k in ("onestep_fwd", "onestep_vag", "sh_fwd", "sh_vag"):
                getattr(lib, f"va_fe_{k}_{t}").restype = I
        lib.va_fe_error_string.restype = ctypes.c_char_p
        lib.va_fe_error_string.argtypes = [I]
        lib._va_typed = True
    return lib


def _launch_args(X, pest, rf, c: FeConsts):
    """Check the inputs of a kernel launch and return (X, B, diag, the
    launch's leading arguments, the parameter rows P); P must stay alive
    until the launch is queued."""
    if X.device.type != "cuda" or X.device != c.device:
        raise ValueError(f"X is on {X.device}; the kernel's constants are "
                         f"on {c.device}")
    if X.dtype != c.dtype or X.ndim != 3 or tuple(X.shape[1:]) != (c.N_f,
                                                                   c.D):
        raise ValueError(f"X must be (B, {c.N_f}, {c.D}) {c.dtype}; got "
                         f"{tuple(X.shape)} {X.dtype}")
    if X.stride(2) != 1 or X.stride(1) != c.D:
        X = X.contiguous()
    B = X.shape[0]
    npest = len(c.pidx)
    if (pest is None or tuple(pest.shape) != (B, npest)
            or pest.dtype != c.dtype or pest.device != X.device):
        raise ValueError(f"pest must be ({B}, {npest}) {c.dtype} on "
                         f"{X.device}")
    P, p_bs = param_rows(pest, c)
    diag = isinstance(rf, torch.Tensor)
    if diag:
        if (tuple(rf.shape) != (c.N_f - 1, c.D) or rf.dtype != c.dtype
                or rf.device != X.device or not rf.is_contiguous()):
            raise ValueError(f"rf must be a scalar or a contiguous "
                             f"({c.N_f - 1}, {c.D}) {c.dtype} tensor on "
                             f"{X.device}")
        rf_ptr, rf_s = rf.data_ptr(), 0.0
    else:
        rf_ptr, rf_s = None, float(rf)
    rows = c.M if c.sh else c.N_f
    return X, B, int(diag), (X.data_ptr(), X.stride(0), P.data_ptr(), p_bs,
                             None if c.stim is None else c.stim.data_ptr(),
                             rf_ptr, rf_s, B, rows, c.D), P


def _call(X, fn, name, *args):
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: cudaError {rc} "
            f"({_lib().va_fe_error_string(rc).decode()})")


def _fn(kind, c: FeConsts):
    return getattr(_lib(), f"va_fe_{kind}_"
                   + ("f32" if c.dtype == torch.float32 else "f64"))


def _check_disc(c: FeConsts, want_sh: bool, name: str):
    if c.sh != want_sh:
        raise ValueError(f"{name} does not take the {c.disc!r} disc")


def onestep_fwd_kernel(X, pest, rf, c: FeConsts):
    """Launch fe_onestep_fwd (K6a) on X (B, N_f, D), a CUDA tensor of c's
    dtype whose rows are contiguous, and pest (B, NPest); returns the
    partials (B, c.n_blocks(B)) on PyTorch's current stream,
    without synchronizing. Raises on anything the kernel does not take
    and on a refused launch."""
    global FWD_LAUNCHES
    _check_disc(c, False, "fe_onestep_fwd")
    X, B, diag, common, _P = _launch_args(X, pest, rf, c)
    out = torch.empty(B, c.n_blocks(B), dtype=c.dtype,
                      device=X.device)
    if B == 0:
        return out
    bn = c.rows(B)
    _call(X, _fn("onestep_fwd", c), "fe_onestep_fwd", _MODEL_CODE[c.model],
          _DISC_CODE[c.disc], diag, *common, c.coeffs()[0], bn,
          onestep_threads(c.model, bn, c.D), out.data_ptr())
    FWD_LAUNCHES += 1
    return out


def onestep_vag_kernel(X, pest, rf, c: FeConsts):
    """Launch fe_onestep_vag (K6b with K6a's value), the one-step value
    and gradient in one launch: returns ``(partials, gx, gp)``,
    fe_onestep_fwd's partials (B, c.n_blocks(B)), the unscaled
    gradient rows (B, N_f, D) and the parameters' partials (B, NP,
    blocks), as :func:`onestep_vag_reference`."""
    global ONESTEP_VAG_LAUNCHES
    _check_disc(c, False, "fe_onestep_vag")
    X, B, diag, common, _P = _launch_args(X, pest, rf, c)
    nb = c.n_blocks(B)
    out = (torch.empty(B, nb, dtype=c.dtype, device=X.device),
           torch.empty(B, c.N_f, c.D, dtype=c.dtype, device=X.device),
           torch.empty(B, c.NP, nb, dtype=c.dtype, device=X.device))
    if B == 0:
        return out
    bn = c.rows(B)
    _call(X, _fn("onestep_vag", c), "fe_onestep_vag", _MODEL_CODE[c.model],
          _DISC_CODE[c.disc], diag, *common, *c.coeffs(), bn,
          onestep_threads(c.model, bn, c.D),
          *(t.data_ptr() for t in out[1:] + out[:1]))
    ONESTEP_VAG_LAUNCHES += 1
    return out


def sh_fwd_kernel(X, pest, rf, c: FeConsts):
    """Launch fe_sh_fwd (K6c, K6d for B > 1): returns the partials (B,
    c.n_blocks(B))."""
    global SH_FWD_LAUNCHES
    _check_disc(c, True, "fe_sh_fwd")
    X, B, diag, common, _P = _launch_args(X, pest, rf, c)
    out = torch.empty(B, c.n_blocks(B), dtype=c.dtype,
                      device=X.device)
    if B == 0:
        return out
    h6, h8, _ = c.coeffs()
    bk = c.rows(B)
    _call(X, _fn("sh_fwd", c), "fe_sh_fwd", _MODEL_CODE[c.model], diag,
          *common, h6, h8, bk, sh_threads(c.model, bk, c.D), out.data_ptr())
    SH_FWD_LAUNCHES += 1
    return out


def sh_vag_kernel(X, pest, rf, c: FeConsts):
    """Launch fe_sh_vag (K6c, K6d for B > 1), the Hermite–Simpson value
    and gradient in one launch: returns ``(partials, g_e0, g_m, g_e1,
    gp)``, fe_sh_fwd's partials (B, c.n_blocks(B)), the unscaled
    triplet, each (B, M, D), and the parameters' partials (B, NP,
    blocks), as :func:`sh_vag_reference`."""
    global SH_VAG_LAUNCHES
    _check_disc(c, True, "fe_sh_vag")
    X, B, diag, common, _P = _launch_args(X, pest, rf, c)
    nb = c.n_blocks(B)
    out = [torch.empty(B, nb, dtype=c.dtype, device=X.device)]
    out += [torch.empty(B, c.M, c.D, dtype=c.dtype, device=X.device)
            for _ in range(3)]
    out.append(torch.empty(B, c.NP, nb, dtype=c.dtype, device=X.device))
    if B == 0:
        return tuple(out)
    bk = c.rows(B)
    _call(X, _fn("sh_vag", c), "fe_sh_vag", _MODEL_CODE[c.model], diag,
          *common, *c.coeffs(), bk, sh_threads(c.model, bk, c.D),
          *(t.data_ptr() for t in out[1:] + out[:1]))
    SH_VAG_LAUNCHES += 1
    return tuple(out)


def _on_cpu(X, c: FeConsts) -> bool:
    if X.device.type != "cpu":
        return False
    if X.device != c.device:
        raise ValueError(f"X is on {X.device}; the constants are on "
                         f"{c.device}")
    return True


def fe_partials(X, pest, rf, c: FeConsts):
    """The forward's per-block partials (B, c.n_blocks(B)): the
    plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if _on_cpu(X, c):
        return (sh_fwd_reference if c.sh else onestep_fwd_reference)(
            X, pest, rf, c)
    return (sh_fwd_kernel if c.sh else onestep_fwd_kernel)(X, pest, rf, c)


def _joined(out, pest, c: FeConsts):
    """(gradient rows, full parameter gradient) from a backward's outputs
    (the triplet joined by node under Hermite–Simpson)."""
    P = full_params(pest, c) if c.log_idx else None
    gp = param_grad(out[-1], P, c)
    if c.sh:
        return sh_join(*out[:3], c), gp
    return out[0], gp


def _fused(X, pest, rf, c: FeConsts):
    """The disc's fused value-and-gradient launch (fe_sh_vag or
    fe_onestep_vag), or its plain version for a CPU tensor."""
    if _on_cpu(X, c):
        fn = sh_vag_reference if c.sh else onestep_vag_reference
    else:
        fn = sh_vag_kernel if c.sh else onestep_vag_kernel
    return fn(X, pest, rf, c)


def fe_adjoint(X, pest, rf, c: FeConsts):
    """The backward's unscaled gradient rows (B, N_f, D) and the gradient
    over the full estimation-scale parameter vector (B, NP)
    (:func:`param_grad`): the fused launch, its value partials unread,
    the Hermite–Simpson triplet joined by node; the plain version for a
    CPU tensor."""
    return _joined(_fused(X, pest, rf, c)[1:], pest, c)


def fe_value_and_grad(X, pest, rf, c: FeConsts):
    """FE per member (B,) and its gradients over X (B, N_f, D) and over
    pest (B, NPest), scaled as :class:`_FE` scales them (2/norm; a log
    coordinate through :func:`param_grad`): one fused launch
    (fe_sh_vag, fe_onestep_vag); the plain versions for a CPU tensor."""
    parts, *out = _fused(X, pest, rf, c)
    g_rows, gp = _joined(out, pest, c)
    scale = 2.0 / c.norm
    gpest = (scale * pest_grad(gp, c) if c.pidx
             else torch.zeros_like(pest))
    return parts.sum(dim=1) / c.norm, scale * g_rows, gpest


# ---------------------------------------------------------------------------
# fe(X, pest, rf) and the action
# ---------------------------------------------------------------------------

def _rf_value(rf):
    """rf as the kernels take it: an (N_f-1, D) tensor (detached), else a
    Python float."""
    if isinstance(rf, torch.Tensor) and rf.ndim == 2:
        return rf.detach()
    return float(rf)


class _FE(torch.autograd.Function):
    """FE per member: the forward is one launch (the partials summed and
    divided by norm, as the reference's ``jnp.sum(partials) / norm``); the
    backward one launch (:func:`fe_adjoint`), scaled by 2·g/norm. rf's
    gradient follows the reference's rule: FE/rf for a scalar rf, through
    the plain model error for an (N_f-1, D) rf, only when rf requires
    it. ``plain(X, pest, rf)``
    is the plain model error (``ops.action.model_error``), which
    ``pallas_backward=False`` differentiates with autograd instead."""

    @staticmethod
    def forward(ctx, X, pest, rf, c, pallas_backward, plain):
        val = fe_partials(X, pest, _rf_value(rf), c).sum(dim=1) / c.norm
        ctx.c, ctx.pb, ctx.plain, ctx.rf = c, pallas_backward, plain, rf
        ctx.save_for_backward(X, pest, val)
        return val

    @staticmethod
    def backward(ctx, g):
        X, pest, val = ctx.saved_tensors
        c, rf = ctx.c, ctx.rf
        rf_k = _rf_value(rf)
        gx = gpest = grf = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            if ctx.pb:
                g_rows, gp = fe_adjoint(X, pest, rf_k, c)
                scale = 2.0 * g / c.norm
                gx = scale[:, None, None] * g_rows
                gpest = (scale[:, None] * pest_grad(gp, c) if c.pidx
                         else torch.zeros_like(pest))
            else:
                with torch.enable_grad():
                    Xd = X.detach().requires_grad_(True)
                    pd = pest.detach().requires_grad_(True)
                    gx, gpest = torch.autograd.grad(
                        ctx.plain(Xd, pd, rf_k), (Xd, pd), grad_outputs=g,
                        allow_unused=True)
                if gpest is None:
                    gpest = torch.zeros_like(pest)
        if ctx.needs_input_grad[2]:
            if rf.ndim == 0:
                # FE is linear in a scalar rf: dFE/drf = FE / rf, for free
                grf = torch.sum(g * val / rf.detach())
            else:
                with torch.enable_grad():
                    rd = rf.detach().requires_grad_(True)
                    (grf,) = torch.autograd.grad(
                        ctx.plain(X, pest, rd), rd, grad_outputs=g)
        return gx, gpest, grf, None, None, None


def make_fe_pallas(spec: ProblemSpec, block_n: int = 512,
                   pallas_backward: bool = True, device=None):
    """``fe(X, pest, rf) -> FE`` through K6, batched over the leading dims
    of ``X`` (..., N_f, D) and ``pest`` (..., NPest); ``rf`` a Python
    float, a 0-d tensor or an (N_f-1, D) tensor shared by the batch.
    Differentiable by autograd (see :class:`_FE`). ``fe.value_and_grad(X,
    pest, rf)`` returns (FE, dFE/dX, dFE/dpest), one member's gradient a
    leading index, without autograd's graph (:func:`fe_value_and_grad`:
    one fused launch; rf gets no gradient). ``block_n``:
    the most rows a block (:func:`rows_per_block`). ``device=None`` means
    the CUDA card. Raises ValueError outside :func:`fe_kernel_supported`."""
    device = resolve_device(device)
    if not fe_kernel_supported(spec, 0.0, torch.float32):
        raise ValueError("problem outside K6's envelope (see "
                         "kernels.fe.fe_kernel_supported)")
    consts, specs = {}, {}

    def c_of(dtype):
        if dtype not in consts:
            consts[dtype] = fe_consts(spec, dtype, device, block_n)
            specs[dtype] = _action.device_spec(spec, device, dtype)
        return consts[dtype]

    def plain(X, pest, rf):
        sp = specs[X.dtype]
        return _action.model_error(sp, X, _action.merge_params(sp, pest),
                                   rf)

    def prep(X, pest, rf):
        c = c_of(X.dtype)
        lead = tuple(X.shape[:-2])
        X3 = X.reshape((-1, c.N_f, c.D))
        pest2 = pest.expand(lead + (spec.NPest,)).reshape(
            X3.shape[0], spec.NPest)
        if isinstance(rf, torch.Tensor):
            if rf.ndim == 2:
                rf = rf.to(device=X.device, dtype=X.dtype).contiguous()
            elif rf.ndim != 0:
                raise ValueError("rf must be a scalar or (N_f-1, D)")
            elif not rf.requires_grad:
                rf = float(rf)
        return c, lead, X3, pest2, rf

    def fe(X, pest, rf):
        c, lead, X3, pest2, rf = prep(X, pest, rf)
        out = _FE.apply(X3, pest2, rf, c, pallas_backward, plain)
        return out.reshape(lead)

    def value_and_grad(X, pest, rf):
        c, lead, X3, pest2, rf = prep(X, pest, rf)
        v, gx, gp = fe_value_and_grad(X3.detach(), pest2.detach(),
                                      _rf_value(rf), c)
        return (v.reshape(lead), gx.reshape(lead + (c.N_f, c.D)),
                gp.reshape(lead + (spec.NPest,)))

    fe.value_and_grad = value_and_grad
    return fe


def make_action_pallas(spec: ProblemSpec, block_n: int = 512,
                       pallas_backward: bool = True, device=None):
    """``(action, action_parts)`` with K6's FE and ME in plain PyTorch (the
    reference keeps ME in XLA: a cheap strided gather), the contract of
    ``ops.action.make_action``, ``action.engine = 'pallas'``. The records
    (``action_parts``) evaluate K6's forward too.

    With ``pallas_backward`` the action carries
    ``action.value_and_grad(XP, rf) -> (A, dA/dXP)``, which
    ``ops.action.value_and_grad`` (and so every ladder and solver loop)
    takes instead of autograd: ME's gradient in closed form
    (``ops.action.measurement_error_and_grad``), FE's from one fused
    launch, with no graph. ``action`` itself stays differentiable
    by autograd (:class:`_FE`). ``device=None`` means the CUDA card.
    Raises ValueError outside :func:`fe_kernel_supported`
    (:func:`select_action` raises first, naming what waits)."""
    device = resolve_device(device)
    fe = make_fe_pallas(spec, block_n=block_n,
                        pallas_backward=pallas_backward, device=device)
    specs = {}

    def split(XP):
        if XP.device != device:
            raise ValueError(f"XP is on {XP.device}, the action on {device}")
        if XP.dtype not in specs:
            specs[XP.dtype] = _action.device_spec(spec, device, XP.dtype)
        lead = tuple(XP.shape[:-1])
        X = XP[..., : spec.n_state].reshape(lead + (spec.N_f, spec.D))
        return specs[XP.dtype], lead, X, XP[..., spec.n_state:]

    def action_parts(XP, rf):
        sp, _, X, pest = split(XP)
        me = _action.measurement_error(sp, X)
        fe_v = fe(X, pest, _action.rf_arg(rf, XP.dtype, device))
        return me + fe_v, me, fe_v

    def action(XP, rf):
        return action_parts(XP, rf)[0]

    def value_and_grad(XP, rf):
        sp, lead, X, pest = split(XP.detach())
        me, g_me = _action.measurement_error_and_grad(sp, X)
        fe_v, g_x, g_p = fe.value_and_grad(
            X, pest, _action.rf_arg(rf, XP.dtype, device))
        g = torch.cat([(g_me + g_x).reshape(lead + (spec.n_state,)), g_p],
                      dim=-1)
        return me + fe_v, g

    if pallas_backward:
        action.value_and_grad = value_and_grad
    action.engine = "pallas"
    return action, action_parts
