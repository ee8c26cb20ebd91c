"""K2 and K3 of the port on the built-in row-level models (NaKL with its
stimulus, Colpitts, Lorenz-63; varanneal_tpu_torch/kernels/solve.py, the
kernels csrc/solve_models_<model>_<f32|f64>.cu, whose plain versions run
here on the CPU), and the float32 gate of ``solver='auto'``:

- K2's plain version (``solve.solve_reference``: the two-loop L-BFGS over
  K1's plain action) against the port's generic loop (``lbfgs_minimize``
  over the autograd action) on short f64 solves, each model under each
  rule with a scalar and an (N_f-1, D) rf, bounded or not: niter, nfev and
  status equal, f to 1e-10 relative;
- K3's plain version (``solve.ladder_reference``) against the generic
  loop's warm-started rungs, three rungs a model: counts equal rung by
  rung, A to 1e-10;
- ``solver='auto'`` takes K2 for the three models in float32 on the card
  (m <= 8, N_pad <= 1024) and the generic loop in float64, as the
  reference's gate (``ag_pallas.py:94`` through ``solve_pallas.py:214``)
  does; ``solver='fused'`` keeps float64 (ROADMAP.md §3, fault 8).

The problems are tests/test_torch_ag_models.py's (N = 18 data rows)."""

import dataclasses

import numpy as np
import pytest
import torch

from varanneal_tpu_torch import support
from varanneal_tpu_torch.kernels import ag, solve
from varanneal_tpu_torch.ops import make_action, value_and_grad
from varanneal_tpu_torch.opt import LBFGSOptions, lbfgs_minimize

from tests.test_torch_ag_models import DISCS, MODELS, _rf, problem

SHORT = dict(maxiter=10, m=5, pgtol=1e-8, ftol=1e-12)
#: rf of a rung: the model error weighted like the data's at NaKL's scale
RF = {"nakl": 1e-2, "colpitts": 1.0, "l63": 1.0}


def _generic(st, opts, lo=None, hi=None):
    """The generic loop over the autograd action (the reference's path
    where its solve kernel is not taken)."""
    vag = value_and_grad(make_action(st, device="cpu")[0])
    o = dataclasses.replace(opts, direction="two_loop",
                            bounded_algo="projection")

    def solve_(Z, rf):
        return lbfgs_minimize(lambda z: vag(z, rf), Z, lower=lo, upper=hi,
                              opts=o, device="cpu")
    return solve_


def _box(st, Z):
    """A box around the start that binds: each entry within ±5 % of its
    value's scale (the states') or ±2 % (the parameters)."""
    z = np.abs(Z).max(axis=0) + 1e-3
    frac = np.where(np.arange(st.n_dof) < st.n_state, 0.05, 0.02)
    mid = Z[0]
    return (torch.tensor(mid - frac * z), torch.tensor(mid + frac * z))


@pytest.mark.parametrize("model,disc", [(m, d) for m in MODELS
                                        for d in DISCS])
def test_plain_k2_matches_generic_loop(model, disc):
    """K2's plain version against the generic loop, f64, two members,
    each rf kind, bounded or not: equal counts, f to 1e-10."""
    sj, st, Z = problem(model, disc, seed=6)
    opts = LBFGSOptions(**SHORT)
    c = ag.ag_consts(st, "cpu", torch.float64)
    for kind in ("scalar", "diag"):
        rf = RF[model] * (1.0 if kind == "scalar" else _rf(kind, st))
        rf_t = rf if np.ndim(rf) == 0 else torch.tensor(rf)
        for bounded in (False, True):
            lo, hi = _box(st, Z) if bounded else (None, None)
            rp = solve.solve_reference(torch.tensor(Z), rf_t, c, opts, lo,
                                       hi)
            rg = _generic(st, opts, lo, hi)(torch.tensor(Z), rf_t)
            for k in ("niter", "nfev", "status"):
                assert torch.equal(getattr(rp, k), getattr(rg, k)), (
                    kind, bounded, k, getattr(rp, k), getattr(rg, k))
            assert (rp.niter > 0).all()
            np.testing.assert_allclose(rp.f.numpy(), rg.f.numpy(),
                                       rtol=1e-10)


@pytest.mark.parametrize("model,disc", [
    ("nakl", "SimpsonHermite"), ("colpitts", "trapezoid"),
    ("l63", "euler")])
def test_plain_k3_matches_generic_ladder(model, disc):
    """K3's plain version (through ``make_ladder_solver`` on the CPU)
    against the generic loop's warm-started rungs, three rungs, f64:
    counts equal rung by rung, A to 1e-10."""
    sj, st, Z = problem(model, disc, seed=7)
    opts = LBFGSOptions(**SHORT)
    rfs = RF[model] * np.array([1.0, 2.0, 4.0])
    lad = solve.make_ladder_solver(st, opts, 3, device="cpu")
    _, rec = lad(torch.tensor(Z), rfs)
    gen = _generic(st, opts)
    x = torch.tensor(Z)
    for j, rf in enumerate(rfs):
        r = gen(x, float(rf))
        x = r.x
        for k in ("niter", "nfev", "status"):
            assert torch.equal(rec[k][:, j], getattr(r, k)), (j, k)
        np.testing.assert_allclose(rec["A"][:, j].numpy(), r.f.numpy(),
                                   rtol=1e-10)


def test_solve_preferred_f32_gate():
    """``solver='auto'`` on the card takes K2 for the three models in
    float32 (m <= 8, N_pad <= 1024) and the generic loop in float64, as
    the reference's ``solve_supported`` (float32 only, through
    ``ag_supported``) keeps its ``solve_preferred``; ``solver='fused'``
    takes K2 in float64 too. The device is pinned to the card's policy as
    ``support._card_policy`` pins it; nothing is launched. The parent took
    K2 under 'auto' in float64 (ROADMAP.md §3, fault 8)."""
    opts = LBFGSOptions(m=5)
    f32, f64 = torch.float32, torch.float64
    with support._card_policy() as card:
        for model in MODELS:
            _, st, _ = problem(model, "SimpsonHermite", B=1)
            for rf in (1.0, _rf("diag", st)):
                assert solve.solve_preferred(st, rf, opts, f32, card)
                assert not solve.solve_preferred(st, rf, opts, f64, card)
                assert solve.pick_rung_solver(st, rf, opts, solver="auto",
                                              dtype=f64, device=card) is None
                assert solve.pick_rung_solver(st, rf, opts, solver="auto",
                                              dtype=f32,
                                              device=card) is not None
                assert solve.pick_rung_solver(st, rf, opts, solver="fused",
                                              dtype=f64,
                                              device=card) is not None
        l96 = support._l96_spec(dtype=np.float64)
        assert not solve.solve_preferred(l96, 1.0, opts, f64, card)
        assert solve.pick_rung_solver(l96, 1.0, opts, solver="auto",
                                      dtype=f64, device=card) is None
        assert solve.pick_rung_solver(l96, 1.0, opts, solver="fused",
                                      dtype=f64, device=card) is not None


def test_row_layouts():
    """A row-level model's evaluation area (the staged parameter row and
    the warps' partials) takes the place of Lorenz-96's rings in K2/K3's
    layout: ``ag.ring_cols`` holds it whole, and a member's vectors and
    history go on chip at the three models' shapes."""
    for model in MODELS:
        _, st, _ = problem(model, "trapezoid", B=1)
        c = ag.ag_consts(st, "cpu", torch.float32)
        cols = ag.ring_cols(c)
        assert ag.ring_elems(cols) >= ag.row_area_elems(model)
        assert ag.ring_elems(cols - 1) < ag.row_area_elems(model)
        lay = solve.plan_layout(cols, st.n_dof, 5, torch.float32, True, 4,
                                132)
        assert lay.flags == (solve.VECTORS | solve.HISTORY | solve.BOUNDS)


def test_pack_refuses_row_models():
    """K8 (the packed solve) takes K2's envelope: the three row-level
    models under each rule with a scalar and an (N_f-1, D) rf, in f32 and
    f64, at packs 1–8; it still refuses the log-space NaKL model, naming
    reference fault 7 (the reference's K1 takes that model and cannot
    launch it, ROADMAP.md §3), and m above the reference's 8. The parent
    refused the three models here (ROADMAP.md §2a item 2 (e))."""
    from tests import test_torch_nakl as tn
    from varanneal_tpu_torch import models
    from varanneal_tpu_torch.kernels import solve_pack
    opts = LBFGSOptions(m=5)
    for model in MODELS:
        for disc in DISCS:
            _, st, _ = problem(model, disc, B=1)
            for rf in (1.0, _rf("diag", st)):
                for dt in (torch.float32, torch.float64):
                    assert solve_pack.pack_refusal(st, rf, opts, dt) is None
                    for k in (1, 2, 3, 8):
                        assert solve_pack.pack_supported(st, rf, opts, k, dt,
                                                         device="cpu")
            assert "m = 9" in solve_pack.pack_refusal(st, 1.0,
                                                      LBFGSOptions(m=9))
    _, st, _ = problem("nakl", "trapezoid", B=1)
    log = dataclasses.replace(st, f=models.nakl_log_model(tn.LOG_IDX)[0])
    assert "fault 7" in solve_pack.pack_refusal(log, 1.0, opts)
    assert not solve_pack.pack_supported(log, 1.0, opts, 2, device="cpu")
    with pytest.raises(ValueError, match="fault 7"):
        solve_pack.make_packed_rung_solver(log, opts, 4, device="cpu")
    assert solve_pack.pack_refusal(support._l96_spec(), 1.0, opts) is None
