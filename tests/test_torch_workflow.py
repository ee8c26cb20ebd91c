"""The port's campaign path for BASELINE config #3 on the CPU, held against
the JAX package where both compute the same thing:

- ``ops.multi`` (the multi-protocol problem): the joint action and its
  gradient against ``varanneal_tpu/ops/multi.py``'s, the mean of the
  single actions, the pack/unpack round trip, replicated bounds and the
  spec validation (tests/test_multi.py's cases);
- ``parallel.draw_anchored_problem``/``strip_anchors`` against the JAX
  ones (the extended batch, the freeze boxes, the penalty);
- the facade on a short NaKL problem with its stimulus (Hermite–Simpson,
  bounded, Pidx [1..5], f64, 3 rungs) against the JAX facade, through the
  autograd action and through K6's plain version: niter and status equal,
  A within 1e-10;
- the runner on a NaKL config with a ``stim_file`` against ``python -m
  varanneal_tpu``, each in a subprocess;
- ``workflow`` (tests/test_workflow.py's cases at N <= 41): estimate end
  to end, phase 1 against the JAX phase 1 in f64, the batch split, the
  polish's β values, anchor validation, anchored runs pinning the generic
  loop, a transient fault (the card out of memory) retried, a programming
  error and a kernel wrapper's RuntimeError re-raised, ``_is_transient``
  by type, the five-tuple ``make_problem`` and ``compensated`` reaching
  the solver gate."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import varanneal_tpu
from varanneal_tpu import workflow as workflow_jax
from varanneal_tpu.models import nakl as nakl_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax
from varanneal_tpu.ops import multi as multi_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax
from varanneal_tpu.parallel import (draw_anchored_problem as anchored_jax,
                                    strip_anchors as strip_jax)
from varanneal_tpu.api import build_bounds as build_bounds_jax

import varanneal_tpu_torch
from varanneal_tpu_torch import workflow
from varanneal_tpu_torch.api import build_bounds
from varanneal_tpu_torch.kernels import solve
from varanneal_tpu_torch.models import (NAKL_P_TRUE, nakl,
                                        nakl_ensemble_inits,
                                        nakl_param_boxes)
from varanneal_tpu_torch.ops import build_spec, make_action
from varanneal_tpu_torch.ops.multi import (build_multi_bounds,
                                           make_multi_action, multi_pack,
                                           multi_unpack)
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.parallel import draw_anchored_problem, strip_anchors
from varanneal_tpu_torch.twin import nakl_twin

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
STATE_BOUNDS = [(-150., 70.), (0., 1.), (0., 1.), (0., 1.)]
PIDX = [1, 3, 5]          # gNa, gK, gL
P5 = [1, 2, 3, 4, 5]
BOUNDS5 = STATE_BOUNDS + [(50., 200.), (20., 80.), (5., 60.),
                          (-100., -50.), (0.05, 1.0)]


# ---------------------------------------------------------------------------
# ops.multi
# ---------------------------------------------------------------------------

def _multi_specs(K=2, N=21, disc="SimpsonHermite"):
    """tests/test_multi.py's K protocols, in both packages."""
    out = []
    for k in range(K):
        tw = nakl_twin(N=N, dt=0.04, sigma=1.0, seed=11 + k, seg=7)
        args = (4, tw["V"], tw["t"], [0], 1.0)
        kw = dict(disc=disc, P=np.asarray(NAKL_P_TRUE), pidx=P5,
                  stim=tw["stim"])
        out.append((build_spec(nakl, *args, **kw),
                    build_spec_jax(nakl_jax, *args, **kw)))
    return [s for s, _ in out], [s for _, s in out]


@pytest.mark.parametrize("disc", ["trapezoid", "SimpsonHermite"])
def test_multi_action_matches_jax(disc):
    """Two protocols, f64: (A, ME, FE) equal the JAX joint action's and
    the mean of the port's single actions (1e-12); the gradient equals
    JAX's (1e-10) and splits into each protocol's state block of its
    single action's gradient over K."""
    st, sj = _multi_specs(K=2, disc=disc)
    rng = np.random.default_rng(0)
    Xs = [rng.normal(size=(s.N_f, s.D)) for s in st]
    pest = np.asarray([110.0, 45.0, 22.0, -70.0, 0.4])
    XP = np.asarray(multi_pack(st, Xs))
    XP[2 * st[0].n_state:] = pest
    np.testing.assert_array_equal(
        XP[: 2 * st[0].n_state],
        np.asarray(multi_jax.multi_pack(sj, Xs))[: 2 * st[0].n_state])
    act, parts = make_multi_action(st, device=CPU)
    act_j, parts_j = multi_jax.make_multi_action(sj)
    rf = 2e-3
    got = [float(v) for v in parts(torch.tensor(XP), rf)]
    want = [float(v) for v in parts_j(jnp.asarray(XP), rf)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    singles = []
    for s, X in zip(st, Xs):
        p1 = make_action(s, device=CPU)[1]
        xp1 = torch.tensor(np.concatenate([X.ravel(), pest]))
        singles.append([float(v) for v in p1(xp1, rf)])
    np.testing.assert_allclose(got, np.mean(singles, axis=0), rtol=1e-12)
    x = torch.tensor(XP, requires_grad=True)
    (g,) = torch.autograd.grad(act(x, rf), x)
    g_j = np.asarray(jax.jit(jax.grad(act_j))(jnp.asarray(XP), rf))
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-10,
                               atol=1e-14 * np.max(np.abs(g_j)))
    n = st[0].n_state
    a1 = make_action(st[1], device=CPU)[0]
    x1 = torch.tensor(np.concatenate([Xs[1].ravel(), pest]),
                      requires_grad=True)
    (g1,) = torch.autograd.grad(a1(x1, rf), x1)
    np.testing.assert_allclose(g[n: 2 * n].numpy(), g1[:n].numpy() / 2.0,
                               rtol=1e-12, atol=1e-16)


def test_multi_pack_unpack_bounds_and_validation():
    """The round trip (NumPy and a batched tensor), the bounds equal the
    JAX package's, and specs that do not share (N_f, D, disc) or carry
    time-dependent parameters are refused."""
    st, sj = _multi_specs(K=2)
    rng = np.random.default_rng(1)
    Xs = [rng.normal(size=(s.N_f, s.D)) for s in st]
    XP = multi_pack(st, Xs)
    assert isinstance(XP, np.ndarray)
    Xs2, pest = multi_unpack(st, XP)
    for X, X2 in zip(Xs, Xs2):
        np.testing.assert_array_equal(X2, X)
    assert pest.shape == (5,)
    XPt = torch.tensor(np.stack([XP, 2 * XP]))
    Xst, pt = multi_unpack(st, XPt)
    assert tuple(Xst[1].shape) == (2, st[0].N_f, 4) and tuple(
        pt.shape) == (2, 5)
    torch.testing.assert_close(Xst[1][1], 2 * torch.tensor(Xs[1]))
    lo, hi = build_multi_bounds(st, BOUNDS5, np.float64)
    lo_j, hi_j = multi_jax.build_multi_bounds(sj, BOUNDS5, np.float64)
    np.testing.assert_array_equal(lo, lo_j)
    np.testing.assert_array_equal(hi, hi_j)
    assert build_multi_bounds(st, None, np.float64) == (None, None)
    bad = _multi_specs(K=1, N=23)[0][0]
    with pytest.raises(ValueError, match="share"):
        make_multi_action([st[0], bad], device=CPU)
    tdp = dataclasses.replace(st[0], P_base=np.ones((st[0].N_f, 19)))
    with pytest.raises(ValueError, match="time-dependent"):
        make_multi_action([tdp], device=CPU)
    with pytest.raises(ValueError, match="P_base"):
        make_multi_action([st[0], dataclasses.replace(
            st[1], P_base=np.ones(19))], device=CPU)


# ---------------------------------------------------------------------------
# the draw-anchored prior
# ---------------------------------------------------------------------------

def test_draw_anchored_problem_matches_jax():
    """The extended batch and the per-member freeze boxes equal the JAX
    package's bit for bit (f32 and f64); the anchored action and parts
    equal JAX's vmapped ones (f64 1e-12) on perturbed parameters;
    strip_anchors drops the centers; the argument checks refuse what
    JAX's refuse."""
    st, sj = _multi_specs(K=1, N=15)
    st, sj = st[0], sj[0]
    pb, _ = nakl_param_boxes(P5)
    lo, hi = build_bounds(st, STATE_BOUNDS + pb, np.float64)
    V = np.interp(np.arange(st.N_f) / 2.0, np.arange(15), st.Y[:, 0])
    for dt in (np.float32, np.float64):
        xp = nakl_ensemble_inits(np.random.default_rng(2), 3, pb, [V],
                                 pidx=P5, dtype=dt)
        out = draw_anchored_problem(None, None, xp, lo, hi, n_params=5,
                                    weight=10.0, width=0.25)
        out_j = anchored_jax(None, None, xp, lo, hi, n_params=5,
                             weight=10.0, width=0.25)
        for a, b in zip(out[2:], out_j[2:]):
            assert a.dtype == b.dtype == dt
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(strip_anchors(out[2], 5),
                                      strip_jax(out_j[2], 5))
    act, parts = make_action(st, device=CPU)
    aj, pj = make_action_jax(sj)
    a_t, p_t, xp_e, _, _ = draw_anchored_problem(act, parts, xp, lo, hi,
                                                 n_params=5, weight=10.0)
    a_j, p_j, _, _, _ = anchored_jax(aj, pj, xp, lo, hi, n_params=5,
                                     weight=10.0)
    xq = xp_e.copy()
    xq[:, -10:-5] += np.random.default_rng(3).normal(size=(3, 5))
    got = np.stack([v.numpy() for v in p_t(torch.tensor(xq), 1e-3)])
    want = np.stack([np.asarray(v) for v in jax.vmap(
        lambda z: p_j(z, 1e-3))(jnp.asarray(xq))])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(a_t(torch.tensor(xq), 1e-3).numpy(),
                               want[0], rtol=1e-12)
    assert np.all(got[0] > got[1] + got[2])
    for kw, msg in ((dict(n_params=0), "out of range"),
                    (dict(n_params=5, lower=lo[:-1]), "flat")):
        args = dict(lower=lo, upper=hi, weight=1.0)
        args.update(kw)
        with pytest.raises(ValueError, match=msg):
            draw_anchored_problem(None, None, xp, **args)


# ---------------------------------------------------------------------------
# the facade and the runner on NaKL with its stimulus
# ---------------------------------------------------------------------------

def _facade_problem(N=21):
    tw = nakl_twin(N=N, dt=0.04, sigma=1.0, seed=7, seg=8)
    P0 = np.asarray(NAKL_P_TRUE, float).copy()
    P0[P5] = [110.0, 47.0, 22.0, -72.0, 0.35]
    X0 = np.column_stack([tw["V"][:, 0], tw["traj"][:, 1:]])
    return tw, P0, X0


def test_facade_nakl_matches_jax():
    """examples/nakl.py's problem cut to N=21 (Hermite–Simpson, bounds,
    Pidx [1..5], RM = 1/σ², f64, rungs 0..2 from RF0 = 1e-2), the port's
    facade on the CPU with engine='xla' and with engine='pallas' (K6's
    plain NaKL version) against the JAX facade: niter and status equal, A
    within 1e-10. Each rung stops at 15 iterations: the problem is stiff,
    no rung reaches pgtol within thousands, and the two f64 loops part at
    round-off from ~20 iterations on (2e-2 at 50)."""
    tw, P0, X0 = _facade_problem()
    kw = dict(alpha=1.6, beta_array=np.arange(3), RM=1.0 / tw["sigma"] ** 2,
              RF0=1e-2, Lidx=[0], Pidx=P5, disc="SimpsonHermite",
              bounds=BOUNDS5, opt_args=dict(maxiter=15), dtype=np.float64)
    out = {}
    for nm, mod, f, extra in (
            ("jax", varanneal_tpu, nakl_jax, {}),
            ("xla", varanneal_tpu_torch, nakl, dict(device="cpu")),
            ("pallas", varanneal_tpu_torch, nakl, dict(device="cpu"))):
        ann = mod.Annealer(**extra)
        ann.set_model(f, 4)
        ann.set_data(tw["V"], stim=tw["stim"], t=tw["t"])
        ann.anneal(X0, P0, **kw, **({} if nm == "jax" else dict(engine=nm)))
        out[nm] = ann
    aj = out["jax"]
    assert np.all(aj.niter_array > 1)
    for nm in ("xla", "pallas"):
        ap = out[nm]
        np.testing.assert_array_equal(ap.niter_array, aj.niter_array)
        np.testing.assert_array_equal(ap.exitflags, aj.exitflags)
        np.testing.assert_allclose(ap.A_array, aj.A_array, rtol=1e-10)


def test_runner_nakl_matches_jax(tmp_path):
    """``python -m varanneal_tpu_torch`` on a NaKL config with a
    ``stim_file`` (and ``"engine": "pallas"``, K6's plain version on the
    CPU) against ``python -m varanneal_tpu`` on the same config, in two
    subprocesses that run side by side: the three files, A within 1e-10 at every rung (15
    iterations a rung, as in test_facade_nakl_matches_jax)."""
    N = 17
    tw, P0, X0 = _facade_problem(N)
    np.save(tmp_path / "data.npy", np.column_stack([tw["t"], tw["V"]]))
    np.save(tmp_path / "stim.npy", np.column_stack([tw["t"], tw["stim"]]))
    np.save(tmp_path / "x0.npy", X0)
    files, procs = {}, {}
    for pkg, extra, env_extra in (
            ("varanneal_tpu", {}, dict(JAX_PLATFORMS="cpu")),
            ("varanneal_tpu_torch", {"engine": "pallas"}, {})):
        cfg = dict(model={"name": "nakl", "D": 4},
                   data={"file": str(tmp_path / "data.npy"),
                         "stim_file": str(tmp_path / "stim.npy")},
                   X0=str(tmp_path / "x0.npy"), P0=P0.tolist(),
                   out=str(tmp_path / pkg), alpha=1.6,
                   beta_array={"stop": 3}, RM=1.0, RF0=1e-2, Lidx=[0],
                   Pidx=P5, disc="SimpsonHermite",
                   opt_args={"maxiter": 15},
                   **extra)
        path = tmp_path / f"{pkg}.json"
        path.write_text(json.dumps(cfg))
        cmd = [sys.executable, "-m", pkg, str(path)]
        if pkg == "varanneal_tpu_torch":
            cmd += ["--device", "cpu"]
        with open(tmp_path / f"{pkg}.err", "w") as err:
            procs[pkg] = subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=err,
                env=dict(os.environ, PYTHONPATH=str(ROOT), **env_extra),
                cwd=tmp_path)
    for pkg, proc in procs.items():
        assert proc.wait(timeout=300) == 0, (
            tmp_path / f"{pkg}.err").read_text()[-2000:]
        files[pkg] = [np.load(tmp_path / f"{pkg}_paths.npy"),
                      np.load(tmp_path / f"{pkg}_params.npy"),
                      np.loadtxt(tmp_path / f"{pkg}_action_errors.dat")]
    (pj, qj, ej), (pt, qt, et) = (files["varanneal_tpu"],
                                  files["varanneal_tpu_torch"])
    assert pt.shape == pj.shape == (3, 2 * N - 1, 5)
    assert qt.shape == qj.shape and et.shape == ej.shape == (3, 4)
    assert np.all(np.isfinite(et))
    np.testing.assert_allclose(et[:, 1], ej[:, 1], rtol=1e-10)
    np.testing.assert_allclose(qt, qj, rtol=1e-8)


# ---------------------------------------------------------------------------
# workflow
# ---------------------------------------------------------------------------

def _problem(N=41, pkg="port"):
    """tests/test_workflow.py's problem: nakl_twin(seed 5), gNa/gK/gL
    estimated in their wide boxes, Hermite–Simpson, V observed."""
    tw = nakl_twin(N=N, dt=0.04, sigma=1.0, seed=5)
    pbounds, _ = nakl_param_boxes(PIDX)
    bounds = STATE_BOUNDS + pbounds

    def make_problem(dtype):
        args = (4, tw["V"].astype(dtype), tw["t"], [0], 1.0)
        kw = dict(disc="SimpsonHermite", P=np.asarray(NAKL_P_TRUE),
                  pidx=PIDX, stim=tw["stim"])
        if pkg == "jax":
            spec = build_spec_jax(nakl_jax, *args, **kw)
            action, parts = make_action_jax(spec)
            lo, hi = build_bounds_jax(spec, bounds, dtype)
        else:
            spec = build_spec(nakl, *args, **kw)
            action, parts = make_action(spec, device=CPU)
            lo, hi = build_bounds(spec, bounds, dtype)
        return action, parts, lo, hi

    spec = build_spec(nakl, 4, tw["V"], tw["t"], [0], 1.0,
                      disc="SimpsonHermite", P=np.asarray(NAKL_P_TRUE),
                      pidx=PIDX, stim=tw["stim"])
    return tw, spec, make_problem, pbounds


def _draw_ensemble(spec, tw, pbounds, B, seed=0, dtype=np.float32):
    V_f = np.interp(np.arange(spec.N_f) / 2.0,
                    np.arange(tw["V"].shape[0]), tw["V"][:, 0])
    return nakl_ensemble_inits(np.random.default_rng(seed), B, pbounds,
                               [V_f], pidx=PIDX, dtype=dtype)


def _rf0(spec, scale, dtype):
    return np.broadcast_to(scale * np.array([1.0, 1e3, 1e3, 1e3]),
                           (spec.N_f - 1, 4)).astype(dtype)


def test_estimate_e2e(tmp_path):
    """One call: own-draw anchors, the f32 screen with a snapshot, the f64
    polish from it split one member a batch; the records' shapes, the
    campaign's checkpoint names, estimates inside their boxes, and the
    polish at the screen's last rung no worse than the screen."""
    tw, spec, make_problem, pbounds = _problem(N=21)
    B, n_beta, npar = 3, 4, len(PIDX)
    xp0 = _draw_ensemble(spec, tw, pbounds, B)
    res = workflow.estimate(
        make_problem, xp0, np.arange(n_beta, dtype=np.float32),
        _rf0(spec, 1e-5, np.float32), 2.0, n_params=npar,
        opts=LBFGSOptions(maxiter=20, m=5, pgtol=1e-4, ftol=1e-6),
        anchor_weight=10.0, anchor_width=0.25,
        snapshot_beta=n_beta - 2, polish_top=2, polish_batch=1,
        polish_opts=LBFGSOptions(maxiter=30, pgtol=1e-8, ftol=1e-12),
        polish_extra_betas=2, checkpoint_stem=str(tmp_path / "wf"),
        device=CPU)
    r1 = res.phase1
    assert r1.anchored and r1.A.shape == (B, n_beta)
    assert r1.XP.shape[1] == spec.n_state + 2 * npar
    assert r1.snapshot is not None and res.polish is not None
    assert res.polish.XP.shape == (2, spec.n_state + npar)
    assert res.polish.A.shape == (2, n_beta - (n_beta - 2) + 2)
    assert np.isfinite(res.best_A)
    assert res.best.shape == (spec.n_state + npar,)
    for nm in ("wf_p1_ckpt.npz", "wf_pol_ckpt.npz", "wf_pol1_ckpt.npz"):
        assert (tmp_path / nm).exists()
    for v, b in zip(res.best[-npar:], pbounds):
        assert b[0] - 1e-9 <= v <= b[1] + 1e-9
    col = (n_beta - 1) - (n_beta - 2)
    f32_A = r1.A[res.polish.picks, -1]
    assert np.all(res.polish.A[:, col] <= f32_A * 1.1 + 1e-6)


def test_phase1_matches_jax_f64(tmp_path, monkeypatch):
    """An unanchored f64 screen (B=2, rungs 0..2 dispatched one at a time,
    a checkpoint after each, the bounded projection loop, 8 iterations a rung, as in
    test_facade_nakl_matches_jax) against the JAX package's phase 1 on the
    same draws: niter and status equal, A within 1e-10; resumed from its
    checkpoint after rung 1 it gives the same bits."""
    from varanneal_tpu_torch.anneal import checkpoint as ckmod
    B = 2
    tw, spec, make_problem, pbounds = _problem(N=21)
    xp0 = _draw_ensemble(spec, tw, pbounds, B, seed=4, dtype=np.float64)
    rf0 = _rf0(spec, 1e-4, np.float64)
    betas = np.arange(3, dtype=np.float64)
    kw = dict(maxiter=8, m=5, pgtol=1e-8, ftol=1e-12)
    a, p, lo, hi = make_problem(np.float64)
    stem = str(tmp_path / "s")
    first = {}
    real = ckmod._atomic_savez

    def keep_first(path, **arrays):
        if int(arrays["next_idx"]) == 2:
            first.update(arrays)
        real(path, **arrays)

    monkeypatch.setattr(ckmod, "_atomic_savez", keep_first)

    def run():
        return workflow.phase1(a, p, xp0, betas, rf0, 1.6, lower=lo,
                               upper=hi, opts=LBFGSOptions(**kw),
                               checkpoint_stem=stem, save_every=1,
                               device=CPU)

    r = run()
    aj, pj, loj, hij = _problem(N=21, pkg="jax")[2](np.float64)
    rj = workflow_jax.phase1(aj, pj, xp0, betas, jnp.asarray(rf0), 1.6,
                             lower=loj, upper=hij, opts=OptsJax(**kw),
                             save_every=1)
    np.testing.assert_array_equal(r.niter, rj.niter)
    np.testing.assert_array_equal(r.status, rj.status)
    assert int(r.niter.sum()) > 10
    np.testing.assert_allclose(r.A, rj.A, rtol=1e-10)
    assert int(first["next_idx"]) == 2
    np.savez(stem + "_p1_ckpt.npz", **first)
    r2 = run()
    np.testing.assert_array_equal(r2.A, r.A)
    np.testing.assert_array_equal(r2.XP, r.XP)
    np.testing.assert_array_equal(r2.nfev[:, :2], r.nfev[:, :2])


def test_polish_batch_split_pure_rebatching():
    """batch=1 and batch=0 (one dispatch) give equivalent results: the
    split is a stability knob, not a numerics knob (not bitwise: a batch
    of 1 and of 3 sum in other orders, and 15 iterations of a stiff
    problem amplify that; tests/test_workflow.py's contract)."""
    tw, spec, make_problem, pbounds = _problem(N=21)
    xp0 = _draw_ensemble(spec, tw, pbounds, 3, seed=2, dtype=np.float64)
    action, parts, lo, hi = make_problem(np.float64)

    def run(batch):
        return workflow.polish(action, parts, xp0,
                               np.arange(3, dtype=np.float64),
                               _rf0(spec, 1e-4, np.float64), 2.0,
                               lower=lo, upper=hi,
                               opts=LBFGSOptions(maxiter=15, pgtol=1e-8,
                                                 ftol=1e-12),
                               batch=batch, device=CPU)

    r1, r0 = run(1), run(0)
    np.testing.assert_allclose(r1.A, r0.A, rtol=2e-2)
    np.testing.assert_allclose(r1.XP[:, -3:], r0.XP[:, -3:], rtol=5e-2)
    assert r1.XP.shape == r0.XP.shape
    np.testing.assert_array_equal(r1.picks, np.arange(3))
    assert workflow.safe_polish_batch() == 0


def test_estimate_polish_betas_use_ladder_values(monkeypatch):
    """The polish continues in β-value space: with betas 10..15 and a
    snapshot after rung index 4 it runs 14, 15, then 16, 17."""
    tw, spec, make_problem, pbounds = _problem(N=21)
    xp0 = _draw_ensemble(spec, tw, pbounds, 2, seed=1)
    captured = {}
    real_polish = workflow.polish

    def spy(action, parts, src, pol_betas, *a, **kw):
        captured["betas"] = np.asarray(pol_betas)
        return real_polish(action, parts, src, pol_betas, *a, **kw)

    monkeypatch.setattr(workflow, "polish", spy)
    workflow.estimate(
        make_problem, xp0, np.arange(10.0, 16.0, dtype=np.float32),
        _rf0(spec, 1e-9, np.float32), 2.0, n_params=3,
        opts=LBFGSOptions(maxiter=10, m=4), snapshot_beta=4, polish_top=1,
        polish_extra_betas=2, polish_opts=LBFGSOptions(maxiter=10),
        device=CPU)
    np.testing.assert_allclose(captured["betas"], [14.0, 15.0, 16.0, 17.0])


def test_phase1_anchor_checks_and_generic_pin(monkeypatch):
    """anchor_weight needs n_params; an anchored screen never builds the
    whole-rung kernel (solver='fused' warns), an explicit rung_solver
    wins, and ``compensated`` reaches the solver gate."""
    tw, spec, make_problem, pbounds = _problem(N=21)
    action, parts, lo, hi = make_problem(np.float32)
    xp0 = _draw_ensemble(spec, tw, pbounds, 2)
    betas = np.arange(2, dtype=np.float32)
    with pytest.raises(ValueError, match="n_params"):
        workflow.phase1(action, parts, xp0, betas, np.float32(1e-5), 2.0,
                        lower=lo, upper=hi, anchor_weight=1.0, device=CPU)
    seen = []
    monkeypatch.setattr(solve, "pick_rung_solver",
                        lambda *a, **k: seen.append(k) or None)
    with pytest.warns(UserWarning, match="anchor"):
        workflow.phase1(action, parts, xp0, betas, np.float32(1e-6), 2.0,
                        lower=lo, upper=hi,
                        opts=LBFGSOptions(maxiter=5, m=4), n_params=3,
                        anchor_weight=1.0, spec=spec, solver="fused",
                        device=CPU)
    assert seen == []
    opts = LBFGSOptions(maxiter=5, m=4)
    for comp in (False, True):
        workflow.phase1(action, parts, xp0, betas, np.float32(1e-6), 2.0,
                        lower=lo, upper=hi, opts=opts, spec=spec,
                        compensated=comp, device=CPU)
        assert seen[-1]["compensated"] is comp
        assert seen[-1]["dtype"] == torch.float32
    assert workflow._maybe_rung_solver(spec, 1e-6, opts, "auto", "mine",
                                       lo, hi, np.float32) == "mine"
    assert workflow._maybe_rung_solver(None, 1e-6, opts, "auto", None, lo,
                                       hi, np.float32) is None


def _flaky(calls, exc, n_fail=1):
    real = workflow.run_ladder_checkpointed

    def run(*a, **kw):
        calls["n"] += 1
        if calls["n"] <= n_fail:
            raise exc
        return real(*a, **kw)

    return run


def test_polish_retry_transient_fault(monkeypatch, tmp_path):
    """The card out of memory at the first dispatch: the batch is
    dispatched again (resuming from its checkpoint) and polish completes."""
    tw, spec, make_problem, pbounds = _problem(N=21)
    action, parts, lo, hi = make_problem(np.float64)
    xp0 = _draw_ensemble(spec, tw, pbounds, 2, seed=3, dtype=np.float64)
    calls = {"n": 0}
    monkeypatch.setattr(workflow, "_dispatch", _flaky(
        calls, torch.cuda.OutOfMemoryError("CUDA out of memory")))
    r = workflow.polish(action, parts, xp0, np.arange(3, dtype=np.float64),
                        _rf0(spec, 1e-4, np.float64), 2.0, lower=lo,
                        upper=hi, opts=LBFGSOptions(maxiter=15, m=4),
                        batch=0, retries=2, retry_wait=0.0,
                        checkpoint_stem=str(tmp_path / "rt"), device=CPU)
    assert calls["n"] == 2
    assert r.A.shape == (2, 3) and np.all(np.isfinite(r.A))


@pytest.mark.parametrize("exc", [
    ValueError("shape bug"),
    RuntimeError("fe_sh_vag launch failed: cudaError 700 (an illegal "
                 "memory access was encountered)")])
def test_polish_nontransient_fault_reraises(monkeypatch, exc):
    """A programming error and a kernel wrapper's failed launch re-raise
    at the first dispatch: a retry must not hide a kernel's fault."""
    tw, spec, make_problem, pbounds = _problem(N=21)
    action, parts, lo, hi = make_problem(np.float64)
    xp0 = _draw_ensemble(spec, tw, pbounds, 2, seed=3, dtype=np.float64)
    calls = {"n": 0}
    monkeypatch.setattr(workflow, "_dispatch", _flaky(calls, exc, 9))
    with pytest.raises(type(exc), match=str(exc)[:10]):
        workflow.polish(action, parts, xp0, np.arange(2, dtype=np.float64),
                        np.float64(1e-4), 2.0, lower=lo, upper=hi,
                        retries=3, retry_wait=0.0, device=CPU)
    assert calls["n"] == 1


def test_is_transient_by_type():
    """Only the card running out of memory is transient; the reference's
    text markers make no RuntimeError transient here."""
    XlaRuntimeError = type("XlaRuntimeError", (RuntimeError,), {})
    assert workflow._is_transient(torch.cuda.OutOfMemoryError("oom"))
    for e in (XlaRuntimeError("UNAVAILABLE"), RuntimeError("socket closed"),
              RuntimeError("worker INTERNAL connection"),
              RuntimeError("fe_sh_fwd launch failed: cudaError 2"),
              ValueError("UNAVAILABLE"), TypeError("bad arg"),
              KeyError("k"), AttributeError("a"), AssertionError(),
              NotImplementedError("later slice"), OSError("io")):
        assert not workflow._is_transient(e), e
    assert workflow_jax._is_transient(RuntimeError("socket closed"))


def test_estimate_five_tuple_make_problem():
    """make_problem may return (action, parts, lo, hi, spec): the spec
    feeds the solver gate (the generic loop on the CPU); polish_top=0
    skips the polish."""
    tw, spec, make_problem, pbounds = _problem(N=21)

    def make_problem5(dtype):
        return make_problem(dtype) + (spec,)

    xp0 = _draw_ensemble(spec, tw, pbounds, 2)
    res = workflow.estimate(
        make_problem5, xp0, np.arange(3, dtype=np.float32),
        _rf0(spec, 1e-5, np.float32), 2.0, n_params=3,
        opts=LBFGSOptions(maxiter=10, m=4), polish_top=0, device=CPU)
    assert res.polish is None and np.isfinite(res.best_A)
    assert res.best.shape == (spec.n_state + 3,)
    assert res.best_member == int(res.phase1.order[0])
