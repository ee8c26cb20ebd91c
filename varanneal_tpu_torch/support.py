"""Feature × engine/solver support matrix of the port.

Counterpart of ``varanneal_tpu/support.py``: the same rows (the same
problem variants, built the same way), each cell computed from the
port's real predicates on the CPU, with the card's policy pinned, so no
card is touched and the matrix reads the same on any machine:

- ``engine='pallas'``: :func:`kernels.fe.fe_supported` (the reference's
  predicate: ValueError outside it) and :func:`kernels.fe.fe_refusal`
  (the port's K6 envelope);
- ``engine='ag'``: :func:`kernels.ag.ag_refusal` (ValueError outside
  K1's envelope);
- ``solver='fused'`` and the solver of ``solver='auto'``:
  :func:`kernels.solve.pick_rung_solver`, which asks
  :func:`kernels.solve.solve_refusal` and
  :func:`kernels.solve.solve_preferred` (the solver it returns is built
  lazily and never launched here);
- the engine of ``engine='auto'``: :func:`kernels.fe.ag_preferred` and
  :func:`kernels.fe.pallas_preferred`, then the port's envelope of the
  engine they pick, as ``kernels.fe.select_action`` decides.

Cell values:

- ``served``: a forced request runs on that kernel;
- ``fallback``: the facade serves the generic path instead
  (``solver='fused'`` warns);
- ``error``: a forced request raises ValueError;
- ``waits (§…)``: the reference serves the request and the port raises
  NotImplementedError naming the ROADMAP.md item that will port it.

The auto column reads ``<engine> + <solver>``, as the reference's does.
"""

import contextlib
import dataclasses
import warnings
from typing import List, NamedTuple

import numpy as np
import torch

from varanneal_tpu_torch.kernels import ag, fe, solve
from varanneal_tpu_torch.opt.lbfgs import LBFGSOptions

#: The ROADMAP.md items the port's refusals name (``fe._k6_waits`` and the
#: ``engine='auto'`` refusal of ``fe.select_action``).
WAITS_K6 = "waits (§2a item 3)"
WAITS_K1 = "waits (§2a item 2)"


class MatrixRow(NamedTuple):
    feature: str            # row label (the reference's)
    fe: str                 # engine='pallas' (K6)
    ag: str                 # engine='ag' (K1)
    fused: str              # solver='fused' (K2)
    auto: str               # engine/solver 'auto' on the card
    note: str


def _l96_spec(D=20, N=21, disc="trapezoid", dtype=np.float32, **kw):
    from varanneal_tpu_torch.models import lorenz96
    from varanneal_tpu_torch.ops import build_spec
    from varanneal_tpu_torch.twin import lorenz96_twin
    tw = lorenz96_twin(D=D, N_data=N, n_obs=max(1, int(0.4 * D)))
    P = kw.pop("P", np.array([4.0]))
    pidx = kw.pop("pidx", [0])
    return build_spec(lorenz96, D, tw["Y"].astype(dtype), tw["t"],
                      tw["Lidx"], tw["RM"], disc=disc, P=P, pidx=pidx,
                      **kw)


def _nonuniform_spec():
    # build_spec lays a uniform model grid; a non-uniform t_f is reached
    # only by a hand-built spec, as the reference's row builds it
    spec = _l96_spec()
    t_f = np.asarray(spec.t_f).copy()
    t_f[3:] += 0.013
    return dataclasses.replace(spec, t_f=t_f)


@contextlib.contextmanager
def _card_policy():
    """The predicates' device resolution pinned to the card, so that the
    policies answer as they do on it; nothing is allocated there."""
    card = torch.device("cuda", 0)
    saved = fe.resolve_device, solve.resolve_device
    fe.resolve_device = solve.resolve_device = lambda device=None: card
    try:
        yield card
    finally:
        fe.resolve_device, solve.resolve_device = saved


def _pallas_cell(spec, rf, dtype):
    if not fe.fe_supported(spec, rf):
        return "error"
    return "served" if fe.fe_refusal(spec, rf, dtype) is None else WAITS_K6


def _auto_engine(spec, rf, dtype, card):
    """``select_action(engine='auto')``'s choice on the card, or the item
    its NotImplementedError names."""
    if fe.ag_preferred(spec, rf, dtype, card):
        return "ag" if ag.ag_refusal(spec, rf, dtype) is None else WAITS_K1
    if fe.pallas_preferred(spec, rf, dtype, card):
        return ("pallas" if fe.fe_refusal(spec, rf, dtype) is None
                else WAITS_K6)
    return "xla"


def _solver(spec, rf, opts, solver, dtype, card, box, compensated=False):
    """'fused' where ``pick_rung_solver`` returns the kernel's solver,
    else 'generic' (its warning for a refused ``solver='fused'``
    silenced)."""
    lo, hi = ((None, None) if box is None else
              (np.full(spec.n_dof, box[0]), np.full(spec.n_dof, box[1])))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s = solve.pick_rung_solver(spec, rf, opts, solver=solver, lower=lo,
                                   upper=hi, dtype=dtype,
                                   compensated=compensated, device=card)
    return "generic" if s is None else "fused"


def support_matrix() -> List[MatrixRow]:
    """Build the matrix from the port's predicates on the reference's tiny
    variants. Host-side only: nothing is built or launched."""
    opts = LBFGSOptions(m=5)
    f32 = torch.float32
    rows: List[MatrixRow] = []

    def add(feature, spec, rf, *, dtype=f32, bounded=False,
            compensated=False, subspace=False, multi=False, note=""):
        if multi:
            # ops.multi composes per-protocol autograd actions; scripts
            # pass the multi action to run_ladder, and no engine or solver
            # applies
            rows.append(MatrixRow(feature, "n/a", "n/a", "n/a",
                                  "xla + generic", note))
            return
        o = dataclasses.replace(opts, bounded_algo="subspace") \
            if subspace else opts
        box = (-10.0, 10.0) if bounded else None
        with _card_policy() as card:
            fu = _solver(spec, rf, o, "fused", dtype, card, box, compensated)
            sol = _solver(spec, rf, o, "auto", dtype, card, box, compensated)
            if compensated:
                # the facade: engine='pallas' raises, 'ag' runs K4 where
                # K1 runs, 'auto' the compensated autograd action
                ag_c = ("served" if ag.ag_refusal(spec, rf, dtype, True)
                        is None else "error")
                rows.append(MatrixRow(feature, "error", ag_c,
                                      "served" if fu == "fused"
                                      else "fallback",
                                      f"xla + {sol}", note))
                return
            eng = _auto_engine(spec, rf, dtype, card)
        rows.append(MatrixRow(
            feature, _pallas_cell(spec, rf, dtype),
            "served" if ag.ag_refusal(spec, rf, dtype) is None else "error",
            "served" if fu == "fused" else "fallback",
            f"{eng} + {sol}", note))

    base = _l96_spec()
    rf = 1.0
    add("baseline (trapezoid f32 D=20)", base, rf,
        note="K1, K2 and K6 serve; auto takes the autograd action below "
             "D=256 and K2 at N_pad <= 1024 (the reference's gates)")
    add("large D (one-step, D=256)", _l96_spec(D=256, N=21), rf,
        note="the reference's K1 regime: auto takes K1")
    add("box bounds (projection)", base, rf, bounded=True,
        note="K2 runs the projection algorithm in the kernel")
    add("box bounds (explicit subspace)", base, rf, bounded=True,
        subspace=True,
        note="bounded_algo='subspace' keeps the generic L-BFGS-B; "
             "solver='fused' warns")
    add("SimpsonHermite", _l96_spec(disc="SimpsonHermite"), rf,
        note="K6, K1, K2 and K8 serve Hermite–Simpson; K3 too at a "
             "scalar rf")
    add("diag RF (N-1, D)", base, np.ones((20, 20), np.float32),
        note="K6, K1, K2 and K8 take the (N_f-1, D) rf; K3 a scalar rf")
    add("matrix RF (N-1, D, D)", base, np.ones((3, 20, 20), np.float32),
        note="rank-3 rf: the autograd action only")
    add("time-dependent parameters", _l96_spec(P=np.full((21, 1), 4.0)),
        rf, note="the autograd action only; forced engines raise")
    add("observation stride (dt_model)", _l96_spec(N=11, dt_model=0.025),
        rf, note="the stride is embedded on the host; every kernel "
                 "serves it")
    add("non-uniform time grid", _nonuniform_spec(), rf,
        note="the kernels take a uniform grid; the autograd action only")
    add("compensated f32 sums", base, rf, compensated=True,
        note="engine='ag' runs K4 (two-float sums); auto and K6 stay on "
             "the compensated autograd action")
    add("f64", _l96_spec(dtype=np.float64), 1.0, dtype=torch.float64,
        note="K1, K2 and K6 take float64 on the card when forced; auto "
             "stays on the autograd action and the generic loop (the "
             "reference's gates are float32)")
    add("multi-protocol joint estimation", base, rf, multi=True,
        note="ops.multi composes per-protocol autograd actions")
    add("campaign-length record (N=1001 SH)",
        _l96_spec(N=1001, disc="SimpsonHermite"), rf,
        note="K6 serves it; auto stays generic (N_pad 2,008 is past the "
             "reference's N_pad <= 1024 gate)")
    add("large D fused (D=400, N=161)", _l96_spec(D=400, N=161), rf,
        note="K1's walk and K2 take D=400 (config #5's width)")
    return rows


def markdown_table() -> str:
    """Render the matrix as a Markdown table (README.md's port section
    holds it between markers)."""
    out = ["| feature | engine='pallas' (K6) | engine='ag' (K1) | "
           "solver='fused' (K2) | auto resolves to | note |",
           "|---|---|---|---|---|---|"]
    for r in support_matrix():
        out.append(f"| {r.feature} | {r.fe} | {r.ag} | {r.fused} "
                   f"| {r.auto} | {r.note} |")
    return "\n".join(out)
