"""The port's diag, profiling and support modules (varanneal_tpu_torch/
diag.py, profiling.py, support.py) against the JAX package's, on the CPU:

- ``forward_sensitivity`` (torch, ``torch.func.jacfwd``) against the JAX
  one (``jax.jacfwd`` over ``lax.scan``) to 1e-10 relative on the
  analytic decay case (and that case's closed form), on Colpitts (all
  four parameters) and on NaKL with a stimulus (sub 4);
- ``fisher_report`` to 1e-12, one matrix and a stacked list;
  ``action_levels``, ``estimate_from_ensemble`` and ``path_rmse``
  exactly; ``plot_action_levels`` writes a PNG;
- ``profiling.trace`` writes a trace file with the annotated region, and
  ``ladder_stats`` equals the JAX ``ladder_stats`` on the same records;
- ``support``: the reference's row labels; every cell where the port's
  matrix differs from the reference's pinned with its ROADMAP.md item;
  ``auto`` never resolving to what the port refuses; the ``waits`` value
  held to the NotImplementedError it stands for; README.md's table equal
  to ``markdown_table()``."""

import glob
import os
import re
import types
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from varanneal_tpu import diag as diag_jax
from varanneal_tpu import models as models_jax
from varanneal_tpu import profiling as profiling_jax
from varanneal_tpu import support as support_jax
from varanneal_tpu import twin as twin_jax

from varanneal_tpu_torch import diag, models, profiling, support
from varanneal_tpu_torch.anneal import run_ladder
from varanneal_tpu_torch.kernels import fe, solve_pack
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, make_action
from varanneal_tpu_torch.opt import LBFGSOptions

ROOT = Path(__file__).resolve().parents[1]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_forward_sensitivity_decay():
    """dx/dt = -p x: dV/dp at t_n is -t_n x0 e^{-p t_n}; the relative
    scaling multiplies by p. Against the JAX function to 1e-10 and the
    closed form to 1e-8 (RK4's error at sub 20)."""
    p0, x0, N, dt = 0.7, 2.0, 11, 0.1
    t = dt * np.arange(N)
    expect = (-t * x0 * np.exp(-p0 * t))[:, None]

    def f(t, x, p):
        return -p[0] * x

    S_j = diag_jax.forward_sensitivity(
        lambda t, x, p: -jnp.asarray(p)[0] * x, [x0], t, [p0], [0], sub=20,
        relative=False)
    for rel in (False, True):
        S = diag.forward_sensitivity(f, [x0], t, [p0], [0], sub=20,
                                     relative=rel, device="cpu")
        scale = p0 if rel else 1.0
        assert S.dtype == np.float64 and S.shape == (N, 1)
        assert _rel(S, scale * S_j) <= 1e-10
        np.testing.assert_allclose(S, scale * expect, rtol=1e-8, atol=1e-12)


def test_forward_sensitivity_colpitts_and_nakl():
    """Colpitts (all four parameters, x1 observed, sub 10) and NaKL with a
    stimulus (three parameters, V and h observed, sub 4) against the JAX
    function: 1e-10 relative to the largest entry."""
    tw = twin_jax.colpitts_twin(N_data=9)
    S = diag.forward_sensitivity(models.colpitts, tw["traj"][0], tw["t"],
                                 models.COLPITTS_P_TRUE, device="cpu")
    S_j = diag_jax.forward_sensitivity(models_jax.colpitts, tw["traj"][0],
                                       tw["t"], models_jax.COLPITTS_P_TRUE)
    assert S.shape == (9, 4)
    assert _rel(S, S_j) <= 1e-10
    N = 9
    t = 0.04 * np.arange(N)
    rng = np.random.default_rng(0)
    stim = 20.0 * np.sin(0.3 * np.arange(N)) + rng.normal(0, 2.0, N)
    x0 = [-65.0, 0.1, 0.6, 0.3]
    kw = dict(stim=stim, obs=(0, 2), sub=4)
    S = diag.forward_sensitivity(models.nakl, x0, t, models.NAKL_P_TRUE,
                                 [1, 4, 9], device="cpu", **kw)
    S_j = diag_jax.forward_sensitivity(models_jax.nakl, x0, t,
                                       models_jax.NAKL_P_TRUE, [1, 4, 9],
                                       **kw)
    assert S.shape == (2 * N, 3)
    assert _rel(S, S_j) <= 1e-10
    with pytest.raises(ValueError, match="uniform"):
        diag.forward_sensitivity(models.colpitts, tw["traj"][0],
                                 tw["t"] ** 2, models.COLPITTS_P_TRUE,
                                 device="cpu")


def test_fisher_report_and_levels(tmp_path):
    """fisher_report (one matrix, a stacked list, names and a cut) to
    1e-12; the level clustering, the estimate and the path error exactly;
    the figure written."""
    rng = np.random.default_rng(3)
    S1 = rng.normal(size=(30, 4))
    S1[:, 3] = S1[:, 0] + 1e-4 * rng.normal(size=30)    # a flat direction
    S2 = rng.normal(size=(20, 4))
    for S, kw in ((S1, {}), ([S1, S2], dict(sigma=0.5, names=list("abcd"))),
                  (S1, dict(flat_cut=1e-3, n_components=2))):
        a, b = diag.fisher_report(S, **kw), diag_jax.fisher_report(S, **kw)
        for k in ("F", "eigvals", "eigvecs", "crlb"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=1e-12, atol=1e-12)
        assert len(a.flat) == len(b.flat)
        for (wa, ca), (wb, cb) in zip(a.flat, b.flat):
            assert abs(wa - wb) <= 1e-12 * max(1.0, abs(wb))
            assert [n for _, n in ca] == [n for _, n in cb]
    final = np.array([1.0, 1.02, 5.0, 1.01, 5.2, 30.0])
    for A, gap in ((final, 0.05), (rng.uniform(1, 2, 7), 0.01)):
        a, b = diag.action_levels(A, gap), diag_jax.action_levels(A, gap)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    A = np.array([[1, 2, 9.0], [1, 2, 3.0], [1, 2, 3.05]])
    paths = rng.normal(size=(3, 5, 2))
    best, sel, lv = diag.estimate_from_ensemble(A, paths)
    best_j, sel_j, lv_j = diag_jax.estimate_from_ensemble(A, paths)
    assert best == best_j == 1
    np.testing.assert_array_equal(sel, sel_j)
    np.testing.assert_array_equal(lv.counts, lv_j.counts)
    Xt = rng.normal(size=(11, 4))
    Xe = Xt + 0.1 * rng.normal(size=Xt.shape)
    for args in ((Xe, Xt), (Xe, Xt, [0, 2], 4), (Xe, Xt, [0, 1, 2, 3])):
        assert diag.path_rmse(*args) == diag_jax.path_rmse(*args)
    png = tmp_path / "levels.png"
    diag.plot_action_levels(rng.uniform(1, 10, (3, 6)), fname=str(png))
    assert png.stat().st_size > 0


def test_profiling_trace_and_ladder_stats(tmp_path):
    """A 3-rung ladder of a small Lorenz-96 problem (B=2) on the CPU
    inside ``trace``: a trace file holding the annotated region; its
    ``ladder_stats`` equal the JAX function's on the same records."""
    rng = np.random.default_rng(0)
    t = 0.025 * np.arange(9)
    spec = build_spec(lorenz96, 5, rng.normal(size=(9, 2)), t, [0, 2], 4.0,
                      P=np.array([8.0]), pidx=[0])
    action, parts = make_action(spec, device="cpu")
    xp0 = torch.tensor(rng.normal(size=(2, spec.n_dof)))
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        with profiling.annotate("va-ladder"):
            res = run_ladder(action, parts, xp0, np.arange(3.0), 1e-4, 1.7,
                             opts=LBFGSOptions(maxiter=10),
                             store_paths=False, device="cpu")
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1 and "va-ladder" in Path(files[0]).read_text()
    got = profiling.ladder_stats(res)
    recs = types.SimpleNamespace(**{k: getattr(res, k).numpy() for k in (
        "A", "nfev", "niter", "status")})
    want = profiling_jax.ladder_stats(recs)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["n_beta"] == 3 and got["total_nfev"] >= got["total_niter"]


#: Every cell where the port's matrix differs from the reference's:
#: (feature, column) -> (port's cell, reference's cell, why: the ROADMAP.md
#: item that will port it, or where the port serves more).
DIFFERENCES = {
    ("f64", "ag"): ("served", "error", "wider: the port's K1 takes f64"),
    ("f64", "fused"): ("served", "fallback",
                       "wider: the port's K2 takes f64"),
}
COLUMNS = ("fe", "ag", "fused", "auto")


def test_support_matrix_against_reference():
    rows, ref = support.support_matrix(), support_jax.support_matrix()
    assert [r.feature for r in rows] == [r.feature for r in ref]
    diffs = {}
    for r, q in zip(rows, ref):
        for col in COLUMNS:
            if getattr(r, col) != getattr(q, col):
                diffs[(r.feature, col)] = (getattr(r, col), getattr(q, col))
    assert diffs == {k: v[:2] for k, v in DIFFERENCES.items()}
    for r in rows:
        eng, _, sol = r.auto.partition(" + ")
        assert eng in ("xla", "n/a") or eng.startswith("waits") or (
            {"ag": r.ag, "pallas": r.fe}[eng] == "served"), r
        assert sol == "generic" or r.fused == "served", r


def test_support_waits_and_readme(monkeypatch):
    """A ``waits`` cell is what select_action raises NotImplementedError
    for, naming the same item: K6 on a user model, and engine='auto' on
    the card where the reference takes K1 and the port's K1 refuses (a
    user model at D=256 under euler, f32: §2a item 2 (f)). README.md's
    table is ``markdown_table()``."""
    rng = np.random.default_rng(1)
    Y, t = rng.normal(size=(5, 2)), 0.025 * np.arange(5)
    user = build_spec(lambda t, x, p: -x, 3, Y, t, [0, 1], 1.0,
                      P=np.array([1.0]), pidx=[0])
    assert support._pallas_cell(user, 1.0, torch.float64) == support.WAITS_K6
    with pytest.raises(NotImplementedError, match="§2a item 3"):
        fe.select_action(user, 1.0, engine="pallas", device="cpu")
    wide = build_spec(lambda tt, x, p: lorenz96(tt, x, p), 256, Y, t,
                      [0, 1], 1.0, P=np.array([8.0]), pidx=[0],
                      disc="euler")
    with support._card_policy() as card:
        assert support._auto_engine(wide, 0.01, torch.float32,
                                    card) == support.WAITS_K1
    monkeypatch.setattr(fe, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    with pytest.raises(NotImplementedError, match=r"§2a item 2 \(f\)"):
        fe.select_action(wide, 0.01, engine="auto")
    readme = (ROOT / "README.md").read_text()
    m = re.search(r"<!-- support-matrix:begin -->\n(.*?)\n"
                  r"<!-- support-matrix:end -->", readme, re.S)
    assert m and m.group(1) == support.markdown_table()


def test_support_notes_match_pack_envelope():
    """The matrix's notes on K8 (the packed rung solve) follow its
    envelope: the Hermite–Simpson row's problem and the (N_f-1, D) rf
    row's are inside ``solve_pack.pack_supported`` at packs 2–8, and the
    notes name K8 among the kernels that serve them (they said K8 took
    the trapezoid rule with a scalar rf, its envelope before it took
    K2's)."""
    notes = {r.feature: r.note for r in support.support_matrix()}
    opts = LBFGSOptions(m=5)
    sh = support._l96_spec(disc="SimpsonHermite")
    base = support._l96_spec()
    for k in (2, 4, 8):
        assert solve_pack.pack_supported(sh, 1.0, opts, k, device="cpu")
        assert solve_pack.pack_supported(
            base, np.ones((base.N_f - 1, base.D), np.float32), opts, k,
            device="cpu")
    for feature in ("SimpsonHermite", "diag RF (N-1, D)"):
        assert "K8" in notes[feature].split(";")[0], notes[feature]
        assert "trapezoid" not in notes[feature]

