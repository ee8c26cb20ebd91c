"""K8 of the port (varanneal_tpu_torch/kernels/solve_pack.py, the packed
rung solver) over K2's envelope: Lorenz-96's four rules with a scalar or
(N_f-1, D) rf, and the row-level models NaKL (with its stimulus),
Colpitts and Lorenz-63. The kernels are csrc/pack_kernels.cuh's (built
from csrc/pack_rules_*.cu and csrc/pack_models_*.cu), whose plain version
(``solve_pack.pack_reference``) runs here on the CPU.

- ``make_packed_rung_solver(device="cpu")`` against the reference's K8
  (``solve_pack_pallas.make_packed_rung_solver``, interpret mode, f32) on
  six problems: niter, nfev and status identical, f within max(1e-4
  relative, half the reference K8's own distance from the port's plain
  f64 solve from the same start);
- the plain version over the whole model × rule × rf-kind grid (f64):
  each member of a pack equal to the one-member plain solve to 1e-12;
- the group area: at K8's groups of 64 and 32 threads a row-level model's
  area (its staged parameter row and a warp's partials each,
  ``ag.row_area_elems``) fits the area ``pack_layout`` gives each group.

The row-level problems are tests/test_torch_ag_models.py's (N = 18 data
rows), their rf and box tests/test_torch_solve_models.py's."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu import models as models_jax
from varanneal_tpu.kernels import ag_pallas, solve_pack_pallas, solve_pallas
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax

from varanneal_tpu_torch.kernels import ag, solve, solve_pack
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import spec_from_reference
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.parallel import random_ensemble_inits
from varanneal_tpu_torch.twin import lorenz96_twin

from tests.test_torch_ag_models import DISCS, MODELS, _rf, problem
from tests.test_torch_solve_models import RF, _box

CPU = torch.device("cpu")
#: short solves: maxiter 8, m 5, the two-loop direction
SHORT = dict(maxiter=8, m=5, pgtol=1e-8, ftol=1e-12, direction="two_loop",
             bounded_algo="projection")


@pytest.fixture(autouse=True)
def _interp():
    for mod in (ag_pallas, solve_pallas, solve_pack_pallas):
        mod.set_interpret(True)
    yield
    for mod in (ag_pallas, solve_pallas, solve_pack_pallas):
        mod.set_interpret(False)


def _l96(disc, seed=7, B=5, beta=20):
    """Lorenz-96 at tests/test_torch_pack.py's shape (D = 20, 41 data
    rows, 8 observed, F estimated) under ``disc``, in both packages; B
    starts near the twin's path (its truth on the model grid and F, each
    entry moved by N(0, 0.1)), and the rf of rung ``beta`` (rf0 4e-6·RM,
    alpha 1.5)."""
    tw = lorenz96_twin(D=20, N_data=41, n_obs=8)
    sj = build_spec_jax(models_jax.lorenz96, 20, tw["Y"], tw["t"],
                        tw["Lidx"], tw["RM"], disc=disc, P=np.array([4.0]),
                        pidx=[0])
    st = spec_from_reference(
        {f: getattr(sj, f) for f in sj.__dataclass_fields__}, lorenz96)
    at = np.linspace(0, tw["traj"].shape[0] - 1, st.N_f)
    path = np.stack([np.interp(at, np.arange(tw["traj"].shape[0]),
                               tw["traj"][:, j]) for j in range(20)], -1)
    center = np.concatenate([path.reshape(-1), [tw["F"]]])
    Z = center + 0.1 * np.random.default_rng(seed).normal(
        size=(B, st.n_dof))
    return sj, st, Z, 4e-6 * float(tw["RM"]) * 1.5 ** beta


def _case(model, disc, kind):
    """(JAX spec, port spec, starts, rf) of one problem."""
    if model == "l96":
        sj, st, Z, r = _l96(disc)
    else:
        sj, st, Z = problem(model, disc, B=4, seed=6)
        r = RF[model]
    rf = r if kind == "scalar" else r * _rf("diag", st)
    return sj, st, Z, rf


#: (model, rule, rf kind, pack, B, bounded): six problems over the models,
#: rules, rf kinds and pack sizes, one bounded
REF_CASES = [("nakl", "SimpsonHermite", "diag", 2, 3, False),
             ("nakl", "trapezoid", "scalar", 4, 3, True),
             ("colpitts", "forwardmap", "scalar", 3, 4, False),
             ("l63", "euler", "diag", 4, 3, False),
             ("l96", "SimpsonHermite", "scalar", 3, 4, False),
             ("l96", "euler", "diag", 5, 5, False)]


@pytest.mark.parametrize("model,disc,kind,pack,B,bounded", REF_CASES)
def test_pack_matches_reference_k8(model, disc, kind, pack, B, bounded):
    """The packed solver's plain version (f32, on the CPU) against the
    reference's K8 in interpret mode: niter, nfev and status identical;
    f within max(1e-4 relative, half the reference K8's distance from the
    port's plain f64 solve from the same start). The second term is
    needed where an f32 solve ends on a near-flat valley: there the
    reference's K2 gives its K8's bits, and the f64 solve takes other
    counts and ends elsewhere (Lorenz-63 under Hermite–Simpson at a
    scalar rf of 2e-3, pack 2: the two f32 solves 9.0e-4 apart in f, the
    f64 solve 6.5e-2 away), so the f32 solves' own distance from the f64
    one is what bounds their distance from each other."""
    sj, st, Z, rf = _case(model, disc, kind)
    Z = Z[:B].astype(np.float32)
    rf32 = np.asarray(rf, np.float32)
    kw_j, kw_p = {}, {}
    if bounded:
        lo, hi = (b.numpy() for b in _box(st, Z.astype(np.float64)))
        Z = np.clip(Z, lo, hi).astype(np.float32)
        kw_j = dict(lower=lo, upper=hi)
        kw_p = dict(lower=lo, upper=hi)
    assert solve_pack_pallas.pack_supported(sj, rf32, OptsJax(**SHORT),
                                            pack, bounded=bounded)
    sk = solve_pack_pallas.make_packed_rung_solver(sj, OptsJax(**SHORT),
                                                   pack, **kw_j)
    rj = jax.jit(jax.vmap(lambda z: sk(z, jnp.asarray(rf32))))(
        jnp.asarray(Z))
    sp = solve_pack.make_packed_rung_solver(st, LBFGSOptions(**SHORT), pack,
                                            device=CPU, **kw_p)
    rf_t = float(rf32) if rf32.ndim == 0 else torch.tensor(rf32)
    rp = sp(torch.tensor(Z), rf_t)
    for k in ("niter", "nfev", "status"):
        np.testing.assert_array_equal(getattr(rp, k).numpy(),
                                      np.asarray(getattr(rj, k)), err_msg=k)
    assert int(rp.niter.sum()) > 0
    r64 = sp(torch.tensor(Z, dtype=torch.float64),
             float(rf) if np.ndim(rf) == 0 else torch.tensor(rf))
    f_j = np.asarray(rj.f, np.float64)
    own = np.abs(f_j - r64.f.numpy()) / np.abs(r64.f.numpy())
    tol = np.maximum(1e-4, 0.5 * own)
    err = np.abs(rp.f.numpy().astype(np.float64) - f_j) / np.abs(f_j)
    assert np.all(err <= tol), (err, tol)
    if bounded:             # feasible in the f32 box the solve ran in
        x = rp.x.numpy()
        assert np.all(x >= lo.astype(np.float32))
        assert np.all(x <= hi.astype(np.float32))


GRID = [(m, d) for m in ("l96",) + MODELS for d in DISCS]


@pytest.mark.parametrize("model,disc", GRID)
def test_plain_pack_member_by_member(model, disc):
    """The packed plain solve is each member's one-member plain solve, for
    every model, rule and rf kind (f64, a pack of 3 over 4 members, the
    batch padded): counts exact, x and f to 1e-12."""
    opts = LBFGSOptions(maxiter=5, m=5, pgtol=1e-8, ftol=1e-12)
    for kind in ("scalar", "diag"):
        _, st, Z, rf = _case(model, disc, kind)
        Z = Z[:4]
        c = ag.ag_consts(st, CPU, torch.float64)
        rf_t = rf if np.ndim(rf) == 0 else torch.tensor(rf)
        X = torch.tensor(Z)
        assert solve_pack.pack_supported(st, rf, opts, 3, torch.float64,
                                         device=CPU)
        rk = solve_pack.pack_reference(X, rf_t, c, opts, 3)
        assert int(rk.niter.sum()) > 0
        for b in range(X.shape[0]):
            r1 = solve.solve_reference(X[b:b + 1], rf_t, c, opts)
            for k in ("niter", "nfev", "status"):
                assert int(getattr(rk, k)[b]) == int(getattr(r1, k)[0]), (
                    kind, b, k)
            torch.testing.assert_close(rk.x[b], r1.x[0], rtol=0, atol=1e-12)
            torch.testing.assert_close(rk.f[b], r1.f[0], rtol=1e-12, atol=0)


@pytest.mark.parametrize("model", MODELS)
def test_group_area_holds_row_model(model):
    """At K8's groups of 64 and 32 threads (packs 3–4 and 5–8), the area
    pack_layout gives each group past the solver's partials and alpha
    holds the row-level model's evaluation area at that many warps
    (ag.row_area_elems: the staged parameter row, and 2 + NP partials a
    warp): sized for K2's eight warps it would not (NaKL: 24 values where
    a warp needs 44), and a group's staged row and partials would run into
    its neighbour's area."""
    _, st, _ = problem(model, "trapezoid", B=1)
    for dt in (torch.float32, torch.float64):
        size = torch.finfo(dt).bits // 8
        for pack in (3, 4, 5, 8):
            G = solve_pack.pack_group(pack)
            warps, k = G // 32, solve_pack.block_groups(pack)
            lay = solve_pack.pack_layout(st, dt, pack, 5, 2 * pack)
            assert lay.flags == 0                     # the rings on chip
            assert lay.smem_bytes % (k * size) == 0
            group = lay.smem_bytes // (k * size)
            base = 2 * solve.MAX_RED * warps + solve.MAX_M
            need = ag.row_area_elems(model, warps=warps)
            assert group - base >= need, (pack, group - base, need)
            assert group - base == ag.ring_elems(ag.ring_cols(st, warps),
                                                 warps)
    # K2's width (eight warps) is the default and does not move
    c = ag.ag_consts(st, CPU, torch.float32)
    assert ag.ring_cols(c) == ag.ring_cols(st) == ag.ring_cols(st, 8)
