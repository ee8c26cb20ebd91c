"""Static problem specification for a VA action (NumPy only).

A copy of ``varanneal_tpu/ops/spec.py`` (``ProblemSpec``, ``build_spec``,
``canonical_R``, ``_insert_midpoints``) so that the port never imports the
JAX package. ``spec.f`` holds the port's torch model. The time-sharding pad
helpers wait for the port of ``parallel/timeshard.py``.

:func:`spec_from_reference` rebuilds a spec from the NumPy fields of a JAX
``ProblemSpec``, so that both packages can be given the identical problem.

Grid conventions (pinned decisions — see SURVEY.md "Appendix: verification
checklist"; reference mount was empty so each is [pinned-by-oracle]):

- data grid: ``N_data`` points with spacing ``dt_data``;
- model grid: for euler/trapezoid/forwardmap, ``N_f = (N_data-1)*nskip + 1``
  points with spacing ``dt = dt_data/nskip``; observations couple to model
  points ``0, nskip, 2*nskip, ...`` (``obs_stride = nskip``);
- Hermite–Simpson doubles the grid: ``N_f = 2*((N_data-1)*nskip + 1) - 1``
  points with spacing ``dt/2``; decision variables include the midpoints;
  observations couple to points ``0, 2*nskip, ...`` (``obs_stride =
  2*nskip``). The residual formulas in ``disc.py`` use the full interval
  ``h = dt`` over ``[n, n+2]``.
- time-dependent parameters live on the model grid (shape ``(N_f, NP)``),
  midpoints included under Hermite–Simpson.
"""

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np

DISC_NAMES = ("euler", "trapezoid", "SimpsonHermite", "forwardmap")


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Everything static about one VA problem.

    Array members are NumPy constants the action closes over (moved to
    the device once, when the action is built); only the decision vector
    ``XP`` and the annealed precision ``rf`` are arguments of the action.
    """
    f: Callable                 # vector field f(t, x, p) or f(t, x, (p, stim))
    D: int                      # state dimension
    N_data: int                 # number of data points
    N_f: int                    # model-grid points (doubled-minus-1 for SH)
    disc: str                   # one of DISC_NAMES
    dt: float                   # model integration step h
    t_f: Any                    # (N_f,) model-grid times
    obs_stride: int             # model-grid stride between data points
    Lidx: Tuple[int, ...]       # observed state components (len L)
    Y: Any                      # (N_data, L) observations
    stim_f: Optional[Any]       # (N_f, S) stimulus on model grid, or None
    P_base: Any                 # (NP,) or (N_f, NP) full parameter values
    pidx: Tuple[int, ...]       # indices of estimated parameters (len NPest)
    RM: Any                     # scalar | (N_data, L) | (N_data, L, L)

    @property
    def L(self) -> int:
        return len(self.Lidx)

    @property
    def NP(self) -> int:
        return int(np.shape(self.P_base)[-1]) if np.ndim(self.P_base) else 0

    @property
    def NPest(self) -> int:
        return len(self.pidx)

    @property
    def time_dep_p(self) -> bool:
        return np.ndim(self.P_base) == 2

    @property
    def n_state(self) -> int:
        return self.N_f * self.D

    @property
    def n_par(self) -> int:
        return self.NPest * (self.N_f if self.time_dep_p else 1)

    @property
    def n_dof(self) -> int:
        """Flat decision-vector length (reference packing: states then
        estimated parameters — SURVEY.md §2 'Decision-variable packing')."""
        return self.n_state + self.n_par


def _insert_midpoints(A: np.ndarray) -> np.ndarray:
    """(N, ...) -> (2N-1, ...) with linear-interpolated midpoints, the
    Hermite–Simpson grid-doubling rule [pinned-by-oracle]."""
    A = np.asarray(A)
    out = np.zeros((2 * A.shape[0] - 1,) + A.shape[1:], dtype=A.dtype)
    out[::2] = A
    out[1::2] = 0.5 * (A[:-1] + A[1:])
    return out


def canonical_R(R, N: int, K: int, name: str, time_dependent=None):
    """Expand a user R (RM or RF0) to canonical form.

    Accepted inputs (reference accepts the same zoo — SURVEY.md §2 'RM, RF0
    accept scalar, per-component vector, full matrix, and time-dependent
    variants'):
      scalar            -> scalar
      (K,)              -> (N, K)    tiled over time
      (K, K)            -> (N, K, K) tiled over time
      (N, K)            -> as-is
      (N, K, K)         -> as-is

    ``time_dependent`` disambiguates the N == K case where a 2-D R could be
    either a per-time diagonal (N, K) or a full matrix (K, K): True forces
    the time-dependent reading, False the matrix reading, None (default)
    keeps the time-dependent reading but emits a UserWarning.
    """
    R = np.asarray(R, dtype=np.float64)
    if R.ndim == 0:
        return R
    if R.shape == (K,):
        return np.tile(R[None, :], (N, 1))
    # When N == K, (N, K) and (K, K) are ambiguous; the time-dependent
    # reading wins by default (matches the reference's shape-check order,
    # ``varanneal/va_ode.py :: Annealer.me_gaussian`` [M]) — warn unless the
    # caller disambiguated via ``time_dependent``.
    if R.ndim == 2 and N == K and R.shape == (N, K):
        if time_dependent is None:
            import warnings
            warnings.warn(
                f"{name} has shape {R.shape} with N == K == {N}: "
                "interpreting as time-dependent per-component (N, K) "
                "weights, NOT a full (K, K) precision matrix. Pass "
                "R_time_dependent=True/False (or canonical_R("
                "time_dependent=...)) to silence this warning.",
                UserWarning, stacklevel=2)
            time_dependent = True
        if not time_dependent:
            return np.tile(R[None, :, :], (N, 1, 1))
        return R
    if R.shape == (N, K):
        return R
    if R.shape == (N, K, K):
        return R
    if R.shape == (K, K):
        return np.tile(R[None, :, :], (N, 1, 1))
    raise ValueError(
        f"{name} has invalid shape {R.shape}; expected scalar, ({K},), "
        f"({K},{K}), ({N},{K}) or ({N},{K},{K})")


def build_spec(
    f: Callable,
    D: int,
    Y: np.ndarray,
    t_data: np.ndarray,
    Lidx,
    RM,
    *,
    disc: str = "trapezoid",
    P: np.ndarray = None,
    pidx=None,
    stim: np.ndarray = None,
    dt_model: float = None,
    R_time_dependent=None,
) -> ProblemSpec:
    """Assemble a ProblemSpec from user-facing inputs.

    ``Y``: (N_data, L) observations; ``t_data``: (N_data,) uniformly spaced;
    ``stim``: (N_data, S) or (N_f, S) stimulus; ``dt_model``: optional finer
    model step (must divide dt_data; reference ``dt_model``/``nskip``
    mechanics, SURVEY.md §2).
    """
    if disc not in DISC_NAMES:
        raise ValueError(f"disc must be one of {DISC_NAMES}, got {disc!r}")
    Y = np.asarray(Y, dtype=np.float64)
    t_data = np.asarray(t_data, dtype=np.float64)
    N_data = Y.shape[0]
    if t_data.shape != (N_data,):
        raise ValueError("t_data must have shape (N_data,)")
    Lidx = tuple(int(i) for i in Lidx)
    if Y.shape[1] != len(Lidx):
        raise ValueError(f"Y has {Y.shape[1]} columns but len(Lidx)={len(Lidx)}")
    dt_data = float(t_data[1] - t_data[0])

    if dt_model is None:
        nskip, dt = 1, dt_data
    else:
        nskip = int(round(dt_data / float(dt_model)))
        if not np.isclose(nskip * float(dt_model), dt_data):
            raise ValueError("dt_model must evenly divide dt_data")
        dt = dt_data / nskip

    N_base = (N_data - 1) * nskip + 1
    sh = disc == "SimpsonHermite"
    if sh:
        N_f = 2 * N_base - 1
        grid_dt = dt / 2.0
        obs_stride = 2 * nskip
    else:
        N_f = N_base
        grid_dt = dt
        obs_stride = nskip
    t_f = t_data[0] + grid_dt * np.arange(N_f, dtype=np.float64)

    P = np.zeros((0,)) if P is None else np.asarray(P, dtype=np.float64)
    if P.ndim == 2:
        # time-dependent parameters supplied on the data or base-model grid;
        # lift to the model grid.
        if P.shape[0] == N_data and nskip > 1:
            P = _interp_grid(P, N_base)
        if P.shape[0] == N_base and sh:
            P = _insert_midpoints(P)
        if P.shape[0] != N_f:
            raise ValueError(
                f"time-dependent P has {P.shape[0]} rows; expected "
                f"{N_data}, {N_base} or {N_f}")
    pidx = tuple(range(P.shape[-1])) if pidx is None else tuple(
        int(i) for i in pidx)

    stim_f = None
    if stim is not None:
        stim = np.asarray(stim, dtype=np.float64)
        if stim.ndim == 1:
            stim = stim[:, None]
        if stim.shape[0] == N_data and nskip > 1:
            stim = _interp_grid(stim, N_base)
        if stim.shape[0] == N_base and sh:
            stim = _insert_midpoints(stim)
        if stim.shape[0] != N_f:
            raise ValueError(
                f"stim has {stim.shape[0]} rows; expected {N_data}, "
                f"{N_base} or {N_f}")
        stim_f = stim

    RM = canonical_R(RM, N_data, len(Lidx), "RM",
                     time_dependent=R_time_dependent)

    return ProblemSpec(
        f=f, D=int(D), N_data=N_data, N_f=N_f, disc=disc, dt=dt, t_f=t_f,
        obs_stride=obs_stride, Lidx=Lidx, Y=Y, stim_f=stim_f, P_base=P,
        pidx=pidx, RM=RM)


def _interp_grid(A: np.ndarray, N_out: int) -> np.ndarray:
    """Linear-interpolate rows of A (N_in, K) onto a uniform N_out grid
    spanning the same interval."""
    N_in = A.shape[0]
    xi = np.linspace(0.0, N_in - 1.0, N_out)
    out = np.empty((N_out,) + A.shape[1:], dtype=A.dtype)
    for k in range(A.shape[1]):
        out[:, k] = np.interp(xi, np.arange(N_in), A[:, k])
    return out


_ARRAY_FIELDS = ("t_f", "Y", "stim_f", "P_base", "RM")


def spec_from_reference(fields: dict, model: Callable) -> ProblemSpec:
    """Build the port's :class:`ProblemSpec` from the fields of a JAX
    ``ProblemSpec`` (e.g. ``dataclasses.asdict`` of it, or any mapping
    holding the same names) with ``model`` as the vector field. Array
    fields are copied as float64 NumPy arrays; ``f`` is replaced."""
    kw = {}
    for fld in dataclasses.fields(ProblemSpec):
        if fld.name == "f":
            continue
        v = fields[fld.name]
        if fld.name in _ARRAY_FIELDS and v is not None:
            v = np.array(v, dtype=np.float64)
        elif fld.name in ("Lidx", "pidx"):
            v = tuple(int(i) for i in v)
        elif fld.name in ("D", "N_data", "N_f", "obs_stride"):
            v = int(v)
        elif fld.name == "dt":
            v = float(v)
        kw[fld.name] = v
    if kw["disc"] not in DISC_NAMES:
        raise ValueError(f"disc must be one of {DISC_NAMES}, got "
                         f"{kw['disc']!r}")
    return ProblemSpec(f=model, **kw)
