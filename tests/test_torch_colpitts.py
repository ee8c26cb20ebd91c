"""Colpitts (and Lorenz-63) in the port: the model, the twin, K6 on both
models and the facade and runner on Colpitts, on the CPU, held against
the JAX package with inputs made from numpy seeds:

- ``colpitts`` in f64 against the JAX ``colpitts`` and ``colpitts_np``
  (1e-12), constant and per-row parameters; the constants equal;
- ``colpitts_twin`` bit for bit the JAX package's for the same seed;
- K6's plain versions (the torch model and ``torch.func.vjp``, one
  row-model path) through the port's autograd Function against
  ``fe_pallas.make_fe_pallas`` in interpret mode with block_n=8, for
  Colpitts and Lorenz-63 × the four discs × scalar and (N_f-1, 3) rf:
  value 1e-11 relative, gradient 1e-11 of max|g|;
- the envelope: D, NP, pidx and a stimulus refused, each named;
- the facade in f64 with ``engine='pallas'`` and ``'xla'`` against the
  JAX facade: A within 1e-8 relative at mutually converged rungs
  (5e-8 at rung 0, tests/test_ladder_integration.py's rule);
- ``python -m varanneal_tpu_torch`` on a ``colpitts`` config against
  ``python -m varanneal_tpu`` (both in subprocesses on the CPU)."""

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
from varanneal_tpu import models as models_jax
from varanneal_tpu import twin as twin_jax
from varanneal_tpu.kernels import fe_pallas
from varanneal_tpu.ops import build_spec as build_spec_jax

import varanneal_tpu_torch
from varanneal_tpu_torch import models, twin
from varanneal_tpu_torch.kernels import fe
from varanneal_tpu_torch.ops.spec import spec_from_reference

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
L63_P = np.array([10.0, 28.0, 8.0 / 3.0])


@pytest.fixture(autouse=True)
def _interpret_mode():
    fe_pallas.set_interpret(True)
    yield
    fe_pallas.set_interpret(False)


def test_colpitts_matches_jax_and_numpy():
    """f64 (B, R, 3) states, constant and per-row (R, 4) parameters."""
    assert models.COLPITTS_PNAMES == models_jax.COLPITTS_PNAMES
    assert models.COLPITTS_P_TRUE == models_jax.COLPITTS_P_TRUE
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3))
    p0 = np.asarray(models.COLPITTS_P_TRUE)
    for p in (p0, p0 * (1 + 0.1 * rng.uniform(-1, 1, (9, 4)))):
        got = models.colpitts(None, torch.tensor(x), torch.tensor(p)).numpy()
        want = np.asarray(models_jax.colpitts(None, jnp.asarray(x),
                                              jnp.asarray(p)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        pr = np.broadcast_to(p, (9, 4))
        want_np = np.stack([[twin.colpitts_np(x[b, r], pr[r])
                             for r in range(9)] for b in range(2)])
        np.testing.assert_allclose(got, want_np, rtol=1e-12, atol=1e-12)


def test_colpitts_twin_matches_jax():
    for kw in (dict(N_data=41), dict(N_data=21, dt=0.04, sigma=0.1, seed=3,
                                     spin=500, Lidx=(2, 0))):
        a, b = twin.colpitts_twin(**kw), twin_jax.colpitts_twin(**kw)
        assert set(a) == set(b)
        for k in ("traj", "Y", "t"):
            np.testing.assert_array_equal(a[k], b[k])
        for k in ("Lidx", "RM", "sigma", "dt"):
            assert a[k] == b[k]


def _l63_traj(N, dt, seed):
    """A Lorenz-63 path on its attractor (the twin's RK4)."""
    def fnp(x):
        return np.array([L63_P[0] * (x[1] - x[0]),
                         x[0] * (L63_P[1] - x[2]) - x[1],
                         x[0] * x[1] - L63_P[2] * x[2]])
    x0 = np.random.default_rng(seed).normal(size=3) + [1.0, 1.0, 20.0]
    x0 = twin._rk4_np(fnp, x0, dt, 500)[-1]
    return twin._rk4_np(fnp, x0, dt, N - 1)


def _specs(model, disc, pidx, N=18):
    """Both packages' spec of a Colpitts twin (x1 observed) or a Lorenz-63
    path (x0 and x2 observed), N = 18 data rows (N_f = 35 under
    Hermite–Simpson: 3 blocks of 8 intervals, the last short); returns
    (JAX spec, port spec, the path on the data grid)."""
    if model == "colpitts":
        tw = twin_jax.colpitts_twin(N_data=N)
        traj, Y, t, Lidx = tw["traj"], tw["Y"], tw["t"], tw["Lidx"]
        fj, ft, P = models_jax.colpitts, models.colpitts, np.asarray(
            models.COLPITTS_P_TRUE)
    else:
        traj = _l63_traj(N, 0.01, 1)
        Lidx = [0, 2]
        Y = traj[:, Lidx] + np.random.default_rng(2).normal(size=(N, 2))
        t = 0.01 * np.arange(N)
        fj, ft, P = models_jax.lorenz63, models.lorenz63, L63_P
    sj = build_spec_jax(fj, 3, Y, t, Lidx, 4.0, disc=disc, P=P,
                        pidx=list(pidx))
    return sj, spec_from_reference(dataclasses.asdict(sj), ft), traj


def _draw(st, traj, seed, B=None):
    """States near the path (interpolated onto the model grid, jittered)
    and the estimated parameters 5 % off their base values."""
    rng = np.random.default_rng(seed)
    n = st.N_f
    s = np.arange(n) * (traj.shape[0] - 1) / (n - 1)
    X = np.stack([np.interp(s, np.arange(traj.shape[0]), traj[:, d])
                  for d in range(3)], axis=-1)
    shape = () if B is None else (B,)
    X = X + 0.05 * np.std(traj, axis=0) * rng.normal(size=shape + (n, 3))
    pb = np.asarray(st.P_base)[list(st.pidx)]
    pest = pb + 0.05 * np.abs(pb) * rng.normal(size=shape + (len(st.pidx),))
    return X, pest


def _port_fe(st, X, pest, rf):
    f = fe.make_fe_pallas(st, block_n=8, device=CPU)
    Xt = torch.tensor(X, requires_grad=True)
    pt = torch.tensor(pest, requires_grad=True)
    v = f(Xt, pt, rf if np.ndim(rf) == 0 else torch.tensor(rf))
    gX, gp = torch.autograd.grad(v.sum(), (Xt, pt))
    return v.detach().numpy(), gX.numpy(), gp.numpy()


@pytest.mark.parametrize("model", ["colpitts", "l63"])
@pytest.mark.parametrize("disc", ["euler", "trapezoid", "forwardmap",
                                  "SimpsonHermite"])
@pytest.mark.parametrize("rf_kind", ["scalar", "diag"])
def test_fe_row_models_match_jax(model, disc, rf_kind):
    """The plain versions through the port's autograd Function against the
    JAX package's make_fe_pallas in interpret mode, block_n=8 (several
    blocks, a short last one), every parameter estimated with a scalar rf
    and one (Colpitts' eta, Lorenz-63's rho) with the (N_f-1, 3) rf:
    value 1e-11 relative, gradient 1e-11 of max|g|."""
    NP = 4 if model == "colpitts" else 3
    pidx = tuple(range(NP)) if rf_kind == "scalar" else (NP - 1 if model ==
                                                         "colpitts" else 1,)
    sj, st, traj = _specs(model, disc, pidx)
    assert fe_pallas.fe_supported(sj, 1.0) and fe.fe_supported(st, 1.0)
    assert fe.model_of(st.f) == (model, ())
    for dt in (torch.float32, torch.float64):
        assert fe.fe_refusal(st, 1.0, dt) is None
    X, pest = _draw(st, traj, 3)
    rng = np.random.default_rng(4)
    rf = 2e-3 if rf_kind == "scalar" else rng.uniform(0.5, 2.0, (st.N_f - 1,
                                                                 3))
    fj = fe_pallas.make_fe_pallas(sj, block_n=8)
    rf_j = jnp.asarray(rf)
    v_j, g_j = jax.jit(jax.value_and_grad(lambda x, p: fj(x, p, rf_j),
                                          argnums=(0, 1)))(
        jnp.asarray(X), jnp.asarray(pest))
    v, gX, gp = _port_fe(st, X, pest, rf)
    np.testing.assert_allclose(v, float(v_j), rtol=1e-11)
    for got, want in ((gX, g_j[0]), (gp, g_j[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-11,
                                   atol=1e-11 * np.max(np.abs(want)))


def test_row_models_batch_and_envelope():
    """A batch of 3 Colpitts members under Hermite–Simpson and the
    trapezoid rule: each member's plain value and gradient equal its own
    B=1 evaluation (the partition follows B, so to round-off); the
    envelope names each refused condition, and a user model waits for
    §2a item 3."""
    for disc in ("SimpsonHermite", "trapezoid"):
        _, st, traj = _specs("colpitts", disc, (0, 3))
        X, pest = _draw(st, traj, 5, B=3)
        f = fe.make_fe_pallas(st, block_n=8, device=CPU)
        v, gx, gp = f.value_and_grad(torch.tensor(X), torch.tensor(pest),
                                     1e-2)
        for b in range(3):
            v1, gx1, gp1 = f.value_and_grad(torch.tensor(X[b]),
                                            torch.tensor(pest[b]), 1e-2)
            np.testing.assert_allclose(v[b], v1, rtol=1e-13)
            np.testing.assert_allclose(gx[b], gx1, rtol=1e-13, atol=1e-16)
            np.testing.assert_allclose(gp[b], gp1, rtol=1e-13)
    _, st, _ = _specs("colpitts", "trapezoid", (3,))
    _, s63, _ = _specs("l63", "euler", (1,))
    for bad, why in (
            (dataclasses.replace(st, D=4), "Colpitts with D = 4"),
            (dataclasses.replace(st, P_base=np.ones(3), pidx=(1,)),
             "Colpitts with NP = 3"),
            (dataclasses.replace(st, pidx=(3, 3)), "Colpitts with pidx"),
            (dataclasses.replace(s63, pidx=(3,)), "Lorenz-63 with pidx"),
            (dataclasses.replace(st, stim_f=np.ones((st.N_f, 1))),
             "Colpitts with a stimulus"),
            (dataclasses.replace(st, f=lambda t, x, p: -x), "neither")):
        assert why in fe.fe_refusal(bad, 1.0, torch.float64)
    user = dataclasses.replace(st, f=lambda t, x, p: -x)
    with pytest.raises(NotImplementedError, match="§2a item 3"):
        fe.select_action(user, 1e-2, engine="pallas", device="cpu")


def _colpitts_problem(N=21):
    """The Colpitts twin at N = 21 (dt 0.05, sigma 0.05), every component
    observed, and an initial path near its truth, eta started at 5.5: with
    RF0 = RM every rung is a well-posed problem both packages solve to the
    same minimum. (With x1 alone observed, x2 and x3 lie in a flat valley
    at this N, and neither package's f64 solve converges within 400
    iterations.)"""
    tw = twin_jax.colpitts_twin(N_data=N, Lidx=(0, 1, 2))
    X0 = tw["traj"] + 0.02 * np.random.default_rng(6).normal(
        size=tw["traj"].shape)
    P0 = np.asarray(models.COLPITTS_P_TRUE).copy()
    P0[3] = 5.5
    return tw, X0, P0


def test_facade_colpitts_matches_jax():
    """The facade in f64 on the Colpitts twin, eta estimated, 5 rungs
    solved to gtol 1e-7: the port with engine='pallas' (K6's plain
    versions) and with engine='xla' against the JAX facade's XLA action,
    A within 1e-8 at mutually converged rungs (5e-8 at rung 0)."""
    tw, X0, P0 = _colpitts_problem()
    kw = dict(alpha=2.0, beta_array=np.arange(5), RM=tw["RM"],
              RF0=tw["RM"], Lidx=tw["Lidx"], Pidx=[3],
              opt_args=dict(maxiter=400, gtol=1e-7, ftol=0.0),
              dtype=np.float64)
    out = {}
    for nm, mod, f, extra, engine in (
            ("jax", varanneal_tpu, models_jax.colpitts, {}, "xla"),
            ("pallas", varanneal_tpu_torch, models.colpitts,
             dict(device="cpu"), "pallas"),
            ("xla", varanneal_tpu_torch, models.colpitts,
             dict(device="cpu"), "xla")):
        ann = mod.Annealer(**extra)
        ann.set_model(f, 3)
        ann.set_data(tw["Y"], t=tw["t"])
        ann.anneal(X0, P0, engine=engine, **kw)
        out[nm] = ann
    aj = out["jax"]
    for nm in ("pallas", "xla"):
        ap = out[nm]
        both = (ap.exitflags == 0) & (aj.exitflags == 0)
        assert both.mean() >= 0.8, (ap.exitflags, aj.exitflags)
        rel = np.abs(ap.A_array - aj.A_array) / np.abs(aj.A_array)
        assert rel[0] <= 5e-8, rel
        assert rel[both][1:].max() <= 1e-8, (nm, rel)
    assert out["pallas"].A_array.shape == (5,)


def test_runner_colpitts_matches_jax_runner(tmp_path):
    """``python -m varanneal_tpu_torch`` on a ``colpitts`` config (f64,
    --device cpu) and ``python -m varanneal_tpu`` on the same config: the
    same files and shapes, the records within 1e-8 relative and the paths
    and parameters within 1e-6."""
    tw, X0, P0 = _colpitts_problem(N=17)
    N = tw["t"].shape[0]
    np.save(tmp_path / "data.npy", np.column_stack([tw["t"], tw["Y"]]))
    np.save(tmp_path / "x0.npy", X0)
    files = {}
    for pkg, env_extra in (("varanneal_tpu", dict(JAX_PLATFORMS="cpu")),
                           ("varanneal_tpu_torch", {})):
        cfg = dict(model={"name": "colpitts", "D": 3},
                   data={"file": str(tmp_path / "data.npy")},
                   X0=str(tmp_path / "x0.npy"), P0=P0.tolist(),
                   out=str(tmp_path / pkg), alpha=2.0,
                   beta_array={"stop": 4}, RM=float(tw["RM"]),
                   RF0=float(tw["RM"]), Lidx=list(tw["Lidx"]), Pidx=[3],
                   opt_args={"maxiter": 400, "gtol": 1e-7, "ftol": 0.0})
        path = tmp_path / f"{pkg}.json"
        path.write_text(json.dumps(cfg))
        cmd = [sys.executable, "-m", pkg, str(path)]
        if pkg == "varanneal_tpu_torch":
            cmd += ["--device", "cpu"]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           env=dict(os.environ, PYTHONPATH=str(ROOT),
                                    **env_extra),
                           cwd=tmp_path, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        files[pkg] = [np.load(tmp_path / f"{pkg}_paths.npy"),
                      np.load(tmp_path / f"{pkg}_params.npy"),
                      np.loadtxt(tmp_path / f"{pkg}_action_errors.dat")]
    (pj, qj, ej), (pt, qt, et) = files["varanneal_tpu"], files[
        "varanneal_tpu_torch"]
    assert pt.shape == pj.shape == (4, N, 4)
    assert qt.shape == qj.shape and et.shape == ej.shape == (4, 4)
    np.testing.assert_array_equal(et[:, 0], ej[:, 0])
    assert np.all(np.isfinite(et))
    np.testing.assert_allclose(et[:, 1], ej[:, 1], rtol=1e-8)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(qt, qj, rtol=1e-6)
