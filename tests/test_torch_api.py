"""The port's facade (varanneal_tpu_torch/api.py: Annealer,
make_lbfgs_options, build_bounds; io.py; va_ode.py) against the JAX
package's (varanneal_tpu/api.py) on the CPU in f64, and the policies it
runs through: kernels/fe.select_action (engine) and
kernels/solve.pick_rung_solver (solver).

A Lorenz-96 twin (D=5, N=21, 3 observed), β 0..5, α 1.9, unbounded with
a scalar RF0 and bounded with a per-component RF0: every rung's A, ME and
FE within 1e-8 of A, the exit flags equal. Both facades take the
generic L-BFGS loop here (off the TPU and off the card their solver='auto'
does), each with its own autograd action."""

import dataclasses
import os

import numpy as np
import pytest
import jax
import torch

import varanneal_tpu
from varanneal_tpu import api as api_jax
from varanneal_tpu import io as io_jax
from varanneal_tpu.models import lorenz96 as lorenz96_jax

import varanneal_tpu_torch
from varanneal_tpu_torch import api, io, va_ode
from varanneal_tpu_torch.kernels import ag, fe, solve
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec
from varanneal_tpu_torch.opt import LBFGSOptions
from tests.test_ladder_integration import make_twin

D, N_DATA, LIDX = 5, 21, (0, 1, 3)
BOX = [(-1.5, 7.5)] * 5 + [(3.0, 7.5)]
# Each rung is solved tightly enough that two f64 implementations' stopping
# points agree in A, ME and FE to ~7e-9 of A, with no rung ending on a
# line-search failure at round-off (equal exit flags, all 0): unbounded to
# pgtol 1e-9 (ftol off); bounded to ftol 1e-15 (there pgtol 1e-9 alone is
# never reached before the projected search fails at round-off).
CASES = {"unbounded-scalar": (None, 1e-2, dict(gtol=1e-9, ftol=0.0)),
         "bounded-per-component": (BOX, np.array([1e-2, 2e-2, 5e-3, 1e-2,
                                                  3e-2]),
                                   dict(gtol=1e-10, ftol=1e-15))}


def _twin():
    traj, Y, t, rng = make_twin(D=D, N_data=N_DATA, Lidx=LIDX)
    return traj + 0.5 * rng.normal(size=traj.shape), Y, t


def _kw(bounds, rf0, tols=None):
    return dict(P0=np.array([6.0]), alpha=1.9, beta_array=np.arange(6),
                RM=6.25, RF0=rf0, Lidx=list(LIDX), Pidx=[0],
                opt_args=dict(maxiter=20000, maxcor=5,
                              **(tols or dict(gtol=1e-9))),
                dtype=np.float64, bounds=bounds)


@pytest.fixture(scope="module", params=sorted(CASES))
def annealed(request, tmp_path_factory):
    X0, Y, t = _twin()
    kw = _kw(*CASES[request.param])
    out = {}
    for nm, mod, f, extra in (
            ("jax", varanneal_tpu, lorenz96_jax, {}),
            ("port", varanneal_tpu_torch, lorenz96, dict(device="cpu"))):
        ann = mod.Annealer(**extra)
        ann.set_model(f, D)
        ann.set_data(Y, t=t)
        ann.anneal(X0, **kw)
        d = tmp_path_factory.mktemp(f"{nm}-{request.param}")
        files = {}
        for what in ("paths", "params", "action_errors"):
            for ext in (".npy", ".dat"):
                p = str(d / f"{what}{ext}")
                getattr(ann, f"save_{what}")(p)
                files[what + ext] = (np.load(p) if ext == ".npy"
                                     else np.loadtxt(p))
        out[nm] = (ann, files)
    return request.param, out


def test_annealer_matches_jax(annealed):
    """A, ME and FE at every rung within 1e-8 of the rung's A; equal exit
    flags; the records' shapes and the paths' feasibility. ME and FE are
    held against A, not against themselves: FE is ~1e-3 of A at the low
    rungs, and there the split of A between them moves along the flat
    directions of the minimizer (by ~4e-7 of FE, 1e-9 absolute, between
    the two packages) while A stays within ~1e-10."""
    case, out = annealed
    aj, ap = out["jax"][0], out["port"][0]
    scale = 1e-8 * np.abs(aj.A_array)
    for k in ("A_array", "me_array", "fe_array"):
        a, b = getattr(aj, k), getattr(ap, k)
        assert b.shape == a.shape == (6,) and b.dtype == np.float64
        np.testing.assert_array_less(np.abs(b - a), scale)
    np.testing.assert_array_equal(ap.exitflags, aj.exitflags)
    assert (ap.exitflags == 0).all()
    for k in ("niter_array", "nfev_array", "pgnorm_array"):
        assert getattr(ap, k).shape == (6,)
    assert ap.minpaths.shape == aj.minpaths.shape == (6, ap.spec.n_dof)
    assert ap.minpaths_X.shape == (6, N_DATA, D)
    assert ap.minpaths_P.shape == (6, 1)
    np.testing.assert_array_equal(ap.XP_final, ap.minpaths[-1])
    if CASES[case][0] is not None:
        lo, hi = api.build_bounds(ap.spec, BOX, np.float64)
        assert np.all(ap.minpaths >= lo) and np.all(ap.minpaths <= hi)
        assert np.any(ap.minpaths == lo) or np.any(ap.minpaths == hi)


def test_save_files_match_jax(annealed):
    """The save_* files of the two facades: the same layouts (paths
    (Nβ, N, D+1) with time in column 0; params (Nβ, NPest); action errors
    [β, A, ME, FE]), the time and β columns exact, A/ME/FE to 1e-8 of A
    (see test_annealer_matches_jax). The
    paths and F agree to 5e-3 only: at the low rungs the unobserved
    components are weakly determined, and two tight f64 solves of the same
    rung stop ~1e-3 apart there while their actions agree to 1e-9."""
    _, out = annealed
    fj, fp = out["jax"][1], out["port"][1]
    for k in fj:
        assert fp[k].shape == fj[k].shape, k
    assert fp["paths.npy"].shape == (6, N_DATA, D + 1)
    np.testing.assert_array_equal(fp["paths.npy"][..., 0],
                                  fj["paths.npy"][..., 0])
    np.testing.assert_array_equal(fp["action_errors.dat"][:, 0],
                                  np.arange(6))
    for k in ("action_errors.npy", "action_errors.dat"):
        a = np.abs(fj[k][:, 1:2])
        assert np.all(np.abs(fp[k][:, 1:] - fj[k][:, 1:]) < 1e-8 * a), k
    for k in ("paths.npy", "paths.dat", "params.npy", "params.dat"):
        np.testing.assert_allclose(fp[k], fj[k], atol=5e-3)


def test_io_writers_match_jax(tmp_path):
    """io.py is a copy: the same arrays give byte-identical files."""
    rng = np.random.default_rng(0)
    paths = rng.normal(size=(3, 4, 2))
    t = np.linspace(0, 1, 4)
    params = rng.normal(size=(3, 2))
    params_t = rng.normal(size=(3, 4, 2))
    A, ME = rng.normal(size=3), rng.normal(size=3)
    for ext in (".npy", ".dat"):
        for nm, call in (
                ("paths", lambda m, p: m.save_paths(p, paths, t)),
                ("params", lambda m, p: m.save_params(p, params)),
                ("params_t", lambda m, p: m.save_params(p, params_t, t)),
                ("aerr", lambda m, p: m.save_action_errors(
                    p, np.arange(3), A, ME, A - ME))):
            pj, pp = tmp_path / f"j_{nm}{ext}", tmp_path / f"p_{nm}{ext}"
            call(io_jax, str(pj))
            call(io, str(pp))
            assert pp.read_bytes() == pj.read_bytes(), nm + ext
            np.testing.assert_array_equal(io.load_data(str(pp)),
                                          io_jax.load_data(str(pj)))


@pytest.mark.parametrize("opt_args,dtype", [
    (None, np.float64), (None, np.float32),
    (dict(maxiter=50, maxcor=5, maxls=20, gtol=1e-7, factr=1e7, disp=0,
          maxfun=9), np.float64),
    (dict(m=7, pgtol=1e-3, ftol=1e-5, direction="two_loop",
          bounded_algo="projection"), np.float32)])
def test_make_lbfgs_options_matches_jax(opt_args, dtype):
    p = api.make_lbfgs_options(opt_args, dtype)
    j = api_jax.make_lbfgs_options(opt_args, dtype)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert api.make_lbfgs_options(opt_args, torch.float32 if dtype ==
                                  np.float32 else torch.float64) == p
    with pytest.raises(ValueError):
        api.make_lbfgs_options(dict(bogus=1), dtype)


def test_build_bounds_matches_jax():
    X0, Y, t = _twin()
    st = build_spec(lorenz96, D, Y, t, LIDX, 6.25, P=np.array([6.0]),
                    pidx=[0])
    sj = varanneal_tpu.ops.build_spec(lorenz96_jax, D, Y, t, LIDX, 6.25,
                                      P=np.array([6.0]), pidx=[0])
    bnd = [(None, 7.5), (-1.0, None)] + [(-2.0, 8.0)] * 3 + [(3.0, 9.0)]
    for dt in (np.float32, np.float64):
        lo, hi = api.build_bounds(st, bnd, dt)
        lo_j, hi_j = api_jax.build_bounds(sj, bnd, dt)
        np.testing.assert_array_equal(lo, lo_j)
        np.testing.assert_array_equal(hi, hi_j)
        assert lo.dtype == lo_j.dtype and lo.shape == (st.n_dof,)
    assert api.build_bounds(st, None, np.float64) == (None, None)
    with pytest.raises(ValueError):
        api.build_bounds(st, bnd[:-1], np.float64)


# the kwargs that raised until the checkpointed ladder, the compensated
# sums, the subspace L-BFGS-B, the FE kernels (K6) and the other inner
# solvers (LM/GN, TNC, CG/NCG) were ported; they now run
_LANDED = ({"checkpoint_path"}, {"repeats"}, {"snapshot_beta"},
           {"compensated"}, {"bounds", "opt_args"}, {"engine"}, {"method"})


@pytest.mark.parametrize("kwargs", [
    dict(method="LM"), dict(method="GN"), dict(method="TNC"),
    dict(method="CG"), dict(method="NCG"),
    dict(checkpoint_path="ladder.npz"), dict(repeats=2),
    dict(snapshot_beta=2), dict(compensated=True), dict(engine="pallas"),
    dict(bounds=BOX, opt_args=dict(bounded_algo="subspace"))])
def test_waiting_kwargs_raise(kwargs, tmp_path, monkeypatch):
    """What waits for a later slice raises NotImplementedError naming
    ROADMAP.md; the kwargs this slice ported run (a checkpoint file lands
    in the temporary directory)."""
    monkeypatch.chdir(tmp_path)
    X0, Y, t = _twin()
    ann = api.Annealer(device="cpu")
    ann.set_model(lorenz96, D)
    ann.set_data(Y, t=t)
    kw = dict(_kw(None, 1e-2), beta_array=np.arange(2))
    kw.update(kwargs)
    if set(kwargs) not in _LANDED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ann.anneal(X0, **kw)
        return
    kw["opt_args"] = dict(kw["opt_args"], maxiter=50)
    ann.anneal(X0, **kw)
    assert ann.A_array.shape == (2,) and np.all(np.isfinite(ann.A_array))
    assert os.path.exists("ladder.npz") == ("checkpoint_path" in kwargs)
    assert (ann.XP_snapshot is not None) == ("snapshot_beta" in kwargs)


def test_facade_surface(tmp_path):
    """set_data_fromfile, the default dtype (torch's), va_ode's alias, the
    run checks, and the card: Annealer() means the card."""
    X0, Y, t = _twin()
    f = tmp_path / "data.dat"
    np.savetxt(f, np.column_stack([t, Y]))
    ann = va_ode.Annealer(device="cpu")
    assert va_ode.Annealer is api.Annealer is varanneal_tpu_torch.Annealer
    with pytest.raises(RuntimeError):
        ann.anneal(X0, **_kw(None, 1e-2))       # no model, no data yet
    ann.set_model(lorenz96, D)
    ann.set_data_fromfile(str(f), nstart=1, N=N_DATA - 1)
    np.testing.assert_allclose(ann.data, Y[1:])
    with pytest.raises(RuntimeError):
        ann.save_paths(str(tmp_path / "p.npy"))
    kw = dict(_kw(None, 1e-2), dtype=None, beta_array=np.arange(2),
              opt_args=dict(maxiter=5))
    ann.anneal(X0[1:], **kw)
    assert ann.A_array.dtype == np.dtype(
        str(torch.get_default_dtype()).split(".")[1])
    assert ann.minpaths.shape == (2, ann.spec.n_dof)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.Annealer()


def test_select_action_policy(monkeypatch):
    """engine='auto' takes K1 only in the reference's regime (a one-step
    disc, D >= 256, f32, on the card), under any one-step rule; raises
    where the reference would run a kernel the port lacks (a user model),
    and is the autograd action below it; engine='pallas' takes K6."""
    X0, Y, t = _twin()
    st = build_spec(lorenz96, D, Y, t, LIDX, 6.25, P=np.array([6.0]),
                    pidx=[0])
    act, _ = fe.select_action(st, 0.01, device="cpu")
    assert act.engine == "xla"
    act, _ = fe.select_action(st, 0.01, engine="ag", device="cpu",
                              dtype=torch.float64)
    assert act.engine == "ag"
    act, _ = fe.select_action(st, 0.01, engine="pallas", device="cpu")
    assert act.engine == "pallas"
    with pytest.raises(ValueError):
        fe.select_action(st, 0.01, engine="fast", device="cpu")
    st_e = build_spec(lorenz96, D, Y, t, LIDX, 6.25, P=np.array([6.0]),
                      pidx=[0], disc="euler")
    act, _ = fe.select_action(st_e, 0.01, engine="ag", device="cpu",
                              dtype=torch.float64)
    assert act.engine == "ag"
    # K1 still refuses repeated observed columns (ROADMAP.md §3, fault 6)
    st_r = build_spec(lorenz96, D, Y[:, [0, 1, 0]], t, (0, 1, 0), 6.25,
                      P=np.array([6.0]), pidx=[0], disc="euler")
    with pytest.raises(ValueError):
        fe.select_action(st_r, 0.01, engine="ag", device="cpu")
    # the regime itself needs the card: decide it as the card would
    big = lambda disc: build_spec(            # noqa: E731
        lorenz96, 256, np.zeros((5, 2)), 0.025 * np.arange(5), (0, 1), 1.0,
        P=np.array([8.0]), pidx=[0], disc=disc)
    monkeypatch.setattr(fe, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    assert fe.ag_preferred(big("trapezoid"), 0.01)
    assert not fe.ag_preferred(big("trapezoid"), 0.01, torch.float64)
    assert not fe.ag_preferred(st, 0.01)
    assert not fe.ag_preferred(big("SimpsonHermite"), 0.01)
    # the reference's ag_supported holds at euler, so the reference runs
    # K1 there, and so does the port (the regime's choice: K1, which
    # takes the problem)
    assert fe.ag_preferred(big("euler"), 0.01)
    assert ag.ag_refusal(big("euler"), 0.01) is None
    # a user model there: the reference runs K1, the port's K1 refuses it
    user = build_spec(lambda tt, x, p: lorenz96(tt, x, p), 256,
                      np.zeros((5, 2)), 0.025 * np.arange(5), (0, 1), 1.0,
                      P=np.array([8.0]), pidx=[0], disc="euler")
    with pytest.raises(NotImplementedError, match="K1"):
        fe.select_action(user, 0.01)


def test_config5_takes_k1_and_k2(monkeypatch):
    """BASELINE config #5's shape (Lorenz-96 D=400, N=161, 160 observed,
    trapezoid, F estimated, f32; examples/ensemble_sweep.py) with the
    regime decided as on the card: engine='auto' takes K1 (the first port
    raised here, naming the disc and rf rank though shared memory refused
    it), solver='auto' takes K2, and the planner keeps 1024 members in the
    global layout with the rings on chip. A problem past the kernels'
    32-bit index range is refused, its size named."""
    from varanneal_tpu_torch.kernels import ag
    from varanneal_tpu_torch.twin import lorenz96_twin
    tw = lorenz96_twin(D=400, N_data=161, n_obs=160)
    st = build_spec(lorenz96, 400, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                    disc="trapezoid", P=np.array([4.0]), pidx=[0])
    rf0 = 4e-6 * tw["RM"]
    card = lambda d=None: torch.device("cuda", 0)          # noqa: E731
    monkeypatch.setattr(fe, "resolve_device", card)
    monkeypatch.setattr(solve, "resolve_device", card)
    # K1's constants would go to the card: the engine is what is checked
    monkeypatch.setattr(ag, "make_action_ag",
                        lambda spec, device=None, dtype=None:
                        (lambda *a: None, None))
    assert ag.ag_refusal(st, rf0, torch.float32) is None
    act, _ = fe.select_action(st, rf0, "auto", torch.float32)
    assert act.engine == "ag"
    opts = LBFGSOptions(maxiter=300, m=5, pgtol=1e-4, ftol=1e-6)
    assert solve.solve_preferred(st, rf0, opts)
    assert callable(solve.pick_rung_solver(st, rf0, opts, solver="auto"))
    lay = solve.plan_layout(st.D, st.n_dof, 5, torch.float32, False, 1024,
                            132)
    assert lay.flags == 0 and lay.smem_bytes == solve._smem_bytes(
        400, torch.float32)
    huge = dataclasses.replace(st, N_f=2 ** 22, D=512)
    assert huge.n_dof > ag.MAX_N_DOF
    with pytest.raises(ValueError, match="32-bit index range"):
        fe.select_action(huge, rf0, "ag", torch.float32)
    with pytest.warns(UserWarning, match="32-bit index range"):
        assert solve.pick_rung_solver(huge, rf0, opts,
                                      solver="fused") is None


def test_config5_problem_matches_jax():
    """BASELINE config #5's problem is the JAX package's: the twin
    (lorenz96_twin(D=400, N_data=161, n_obs=160)), the spec built from it
    and the 1024 members of random_ensemble_inits(seed=12), in f32 and
    f64, are equal entry for entry."""
    from varanneal_tpu.ops import build_spec as build_spec_jax
    from varanneal_tpu.parallel import random_ensemble_inits as inits_jax
    from varanneal_tpu.twin import lorenz96_twin as twin_jax
    from varanneal_tpu_torch.parallel import random_ensemble_inits
    from varanneal_tpu_torch.twin import lorenz96_twin
    tj = twin_jax(D=400, N_data=161, n_obs=160)
    tt = lorenz96_twin(D=400, N_data=161, n_obs=160)
    assert sorted(tj) == sorted(tt)
    for k in tj:
        np.testing.assert_array_equal(np.asarray(tt[k]), np.asarray(tj[k]))
    kw = dict(disc="trapezoid", P=np.array([4.0]), pidx=[0])
    sj = build_spec_jax(lorenz96_jax, 400, tj["Y"], tj["t"], tj["Lidx"],
                        tj["RM"], **kw)
    st = build_spec(lorenz96, 400, tt["Y"], tt["t"], tt["Lidx"], tt["RM"],
                    **kw)
    for k in ("Y", "Lidx", "RM", "P_base", "pidx", "N_f", "N_data",
              "obs_stride", "n_dof", "dt", "disc"):
        np.testing.assert_array_equal(np.asarray(getattr(st, k)),
                                      np.asarray(getattr(sj, k)))
    for dt in (np.float32, np.float64):
        xj = np.asarray(inits_jax(sj, 1024, seed=12, dtype=dt))
        xt = random_ensemble_inits(st, 1024, seed=12, dtype=dt)
        assert xt.dtype == xj.dtype and xt.shape == (1024, st.n_dof)
        np.testing.assert_array_equal(xt, xj)


def test_config5_short_ladder_matches_jax():
    """A short warm-started f64 ladder at config #5's full shape (D=400,
    N=161, 160 observed), two seed-12 members, rungs 0..2 (pgtol 1e-8,
    ftol 2.2e-9), through both packages' generic L-BFGS loops and their
    autograd actions: the same niter and status, A within 1e-10. (From
    rung 3, where a rung takes 50+ iterations and stops on ftol, the two
    f64 loops part at round-off and stop elsewhere.)"""
    from varanneal_tpu.anneal import run_ladder as run_ladder_jax
    from varanneal_tpu.ops import build_spec as build_spec_jax
    from varanneal_tpu.ops import make_action as make_action_jax
    from varanneal_tpu.opt import LBFGSOptions as OptsJax
    from varanneal_tpu.parallel import random_ensemble_inits as inits_jax
    from varanneal_tpu.twin import lorenz96_twin as twin_jax
    from varanneal_tpu_torch.anneal import run_ladder
    from varanneal_tpu_torch.ops import make_action
    kw = dict(maxiter=200, m=5, pgtol=1e-8, ftol=2.2e-9)
    tw = twin_jax(D=400, N_data=161, n_obs=160)
    args = (400, tw["Y"], tw["t"], tw["Lidx"], tw["RM"])
    spec_kw = dict(disc="trapezoid", P=np.array([4.0]), pidx=[0])
    sj = build_spec_jax(lorenz96_jax, *args, **spec_kw)
    st = build_spec(lorenz96, *args, **spec_kw)
    rf0 = 4e-6 * tw["RM"]
    xp = inits_jax(sj, 2, seed=12)
    aj, pj = make_action_jax(sj)
    rj = jax.vmap(lambda x: run_ladder_jax(
        aj, pj, x, jax.numpy.arange(3, dtype=jax.numpy.float64), rf0, 1.5,
        opts=OptsJax(**kw), store_paths=False))(jax.numpy.asarray(xp))
    at, pt = make_action(st, device="cpu")
    rt = run_ladder(at, pt, torch.tensor(xp), np.arange(3), rf0, 1.5,
                    opts=LBFGSOptions(**kw), device="cpu")
    np.testing.assert_array_equal(rt.niter.numpy(), np.asarray(rj.niter))
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    assert int(rt.niter.sum()) > 10
    np.testing.assert_allclose(rt.A.numpy(), np.asarray(rj.A), rtol=1e-10,
                               atol=0)


def test_pick_rung_solver_policy(monkeypatch):
    """solver='auto' takes K2 only on the card (solve_preferred, with the
    reference's N_pad <= 1024 cap); 'fused' forces it wherever
    solve_supported holds and otherwise warns; 'generic' never."""
    X0, Y, t = _twin()
    st = build_spec(lorenz96, D, Y, t, LIDX, 6.25, P=np.array([6.0]),
                    pidx=[0])
    opts = LBFGSOptions(m=5)
    pick = solve.pick_rung_solver
    assert pick(st, 0.01, opts, device="cpu") is None
    assert pick(st, 0.01, opts, solver="generic", device="cpu") is None
    assert callable(pick(st, 0.01, opts, solver="fused", device="cpu"))
    lo, hi = api.build_bounds(st, BOX, np.float64)
    assert callable(pick(st, 0.01, opts, solver="fused", lower=lo,
                         upper=hi, device="cpu"))
    for kw in (dict(compensated=True), dict(method="TNC"),
               dict(lower=lo, upper=hi)):
        o = (dataclasses.replace(opts, bounded_algo="subspace")
             if "lower" in kw else opts)
        with pytest.warns(UserWarning):
            assert pick(st, 0.01, o, solver="fused", device="cpu",
                        **kw) is None
    # an (N_f-1, D) rf is K2's (its rules' entries); a per-member one is
    # an rf the kernel cannot take
    assert callable(pick(st, np.ones((N_DATA - 1, D)), opts, solver="fused",
                         device="cpu"))
    with pytest.warns(UserWarning):
        assert pick(st, np.ones((2, N_DATA - 1, D)), opts, solver="fused",
                    device="cpu") is None
    with pytest.raises(ValueError):
        pick(st, 0.01, opts, solver="always", device="cpu")
    monkeypatch.setattr(solve, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    assert solve.solve_preferred(st, 0.01, opts)
    long = build_spec(lorenz96, D, np.zeros((1025, 2)),
                      0.025 * np.arange(1025), (0, 1), 1.0,
                      P=np.array([8.0]), pidx=[0])
    assert solve.solve_supported(long, 0.01, opts)
    assert not solve.solve_preferred(long, 0.01, opts)
    assert pick(long, 0.01, opts, engine="ag") is None
