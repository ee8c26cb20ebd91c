"""K6, the time-blocked FE kernels of the port (varanneal_tpu_torch/
kernels/fe.py), on the CPU: the kernels' plain versions against the JAX
package's Pallas kernels (varanneal_tpu/kernels/fe_pallas.py) run in
interpret mode, as tests/test_pallas.py runs them, in f64.

- ``fe`` value and gradient (X and F) over the four discs × scalar and
  (N_f-1, D) rf, with tests/test_pallas.py's sizes (D=6, N_data 33 and 29
  for uneven blocks, block_n=8; Hermite–Simpson at N_data=23) and its
  bounds: value rtol 1e-12, gradient rtol 1e-11 with atol 1e-14;
- the batched Hermite–Simpson path (B=3) against JAX's vmap of the same
  ``fe`` (which runs the batched-grid kernels K6d);
- ``make_action_pallas`` against JAX's and against the port's autograd
  action (1e-12);
- the engine policy of ``select_action``;
- the facade with ``engine='pallas'`` against the JAX facade (nfev exact,
  A 1e-10), the runner with ``"engine": "pallas"``, and the batched
  checkpointed ladder (the ensemble's path) through K6.

Both packages get the identical problem through
``ops.spec.spec_from_reference``; inputs come from numpy seeds."""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import varanneal_tpu
from varanneal_tpu.kernels import fe_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops.action import (merge_params as merge_params_jax,
                                      model_error as model_error_jax)

import varanneal_tpu_torch
from varanneal_tpu_torch import __main__ as runner
from varanneal_tpu_torch.anneal import run_ladder_checkpointed
from varanneal_tpu_torch.kernels import fe
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.models.lorenz import lorenz63
from varanneal_tpu_torch.ops import build_spec, make_action, pack
from varanneal_tpu_torch.ops.spec import _insert_midpoints, spec_from_reference
from varanneal_tpu_torch.opt import LBFGSOptions
from tests.test_ladder_integration import make_twin

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _interpret_mode():
    fe_pallas.set_interpret(True)
    yield
    fe_pallas.set_interpret(False)


def _specs(disc="trapezoid", N_data=33, D=6, seed=0):
    """tests/test_pallas.py's ``_spec``, in both packages."""
    rng = np.random.default_rng(seed)
    t = 0.025 * np.arange(N_data)
    Y = rng.normal(size=(N_data, 3))
    sj = build_spec_jax(lorenz96_jax, D, Y, t, [0, 2, 4], 4.0, disc=disc,
                        P=np.array([8.17]), pidx=[0])
    return sj, spec_from_reference(dataclasses.asdict(sj), lorenz96), rng


def _rf(kind, spec, rng):
    if kind == "scalar":
        return 3e-3
    return rng.uniform(0.5, 2.0, size=(spec.N_f - 1, spec.D))


def _port_fe(st, X, pest, rf, **kw):
    """The port's fe value and (dX, dpest) by autograd, on the CPU."""
    f = fe.make_fe_pallas(st, block_n=8, device=CPU, **kw)
    Xt = torch.tensor(X, requires_grad=True)
    pt = torch.tensor(pest, requires_grad=True)
    rf_t = rf if np.ndim(rf) == 0 else torch.tensor(rf)
    v = f(Xt, pt, rf_t)
    gX, gp = torch.autograd.grad(v.sum(), (Xt, pt))
    return v.detach().numpy(), gX.numpy(), gp.numpy()


@pytest.mark.parametrize("disc,N_data", [
    ("euler", 33), ("euler", 29), ("trapezoid", 33), ("trapezoid", 29),
    ("forwardmap", 33), ("forwardmap", 29), ("SimpsonHermite", 23)])
@pytest.mark.parametrize("rf_kind", ["scalar", "diag"])
def test_fe_matches_jax(disc, N_data, rf_kind):
    """The plain versions of the forward and of the hand adjoint, through
    the port's autograd Function, against the JAX package's make_fe_pallas
    in interpret mode (block_n=8: several blocks, the last one short at
    N_data=29 in the forward and at 33 in the one-step backward)."""
    sj, st, rng = _specs(disc, N_data)
    assert fe.fe_supported(st, 1.0) == fe_pallas.fe_supported(sj, 1.0)
    assert fe.fe_kernel_supported(st, 1.0, torch.float64)
    X = rng.normal(size=(st.N_f, st.D))
    pest = np.array([7.5])
    rf = _rf(rf_kind, st, rng)
    fj = fe_pallas.make_fe_pallas(sj, block_n=8)
    rf_j = jnp.asarray(rf)
    v_j = float(fj(jnp.asarray(X), jnp.asarray(pest), rf_j))
    g_j = jax.grad(lambda x, p: fj(x, p, rf_j), argnums=(0, 1))(
        jnp.asarray(X), jnp.asarray(pest))
    v, gX, gp = _port_fe(st, X, pest, rf)
    np.testing.assert_allclose(float(v), v_j, rtol=1e-12)
    np.testing.assert_allclose(gX, np.asarray(g_j[0]), rtol=1e-11,
                               atol=1e-14)
    np.testing.assert_allclose(gp, np.asarray(g_j[1]), rtol=1e-11,
                               atol=1e-14)
    # the oracle-pinned model error agrees too
    ref = model_error_jax(sj, jnp.asarray(X), merge_params_jax(
        sj, jnp.asarray(pest), jnp.float64), rf_j)
    np.testing.assert_allclose(float(v), float(ref), rtol=1e-12)


def test_fe_batched_sh_matches_jax_vmap():
    """B=3 Hermite–Simpson members with an (N_f-1, D) rf shared by the
    batch: the port's batch (the kernel's (member, block) grid) against
    JAX's vmap of the same fe, which dispatches to the batched-grid
    kernels; values and the gradient of the summed FE."""
    sj, st, rng = _specs("SimpsonHermite", 23)
    X = rng.normal(size=(3, st.N_f, st.D))
    pest = 7.0 + rng.normal(size=(3, 1))
    rf = _rf("diag", st, rng)
    fj = fe_pallas.make_fe_pallas(sj, block_n=8)
    rf_j = jnp.asarray(rf)
    vj = jax.vmap(lambda x, p: fj(x, p, rf_j))
    v_j = vj(jnp.asarray(X), jnp.asarray(pest))
    g_j = jax.grad(lambda x, p: jnp.sum(vj(x, p)), argnums=(0, 1))(
        jnp.asarray(X), jnp.asarray(pest))
    v, gX, gp = _port_fe(st, X, pest, rf)
    assert v.shape == (3,)
    np.testing.assert_allclose(v, np.asarray(v_j), rtol=1e-12)
    np.testing.assert_allclose(gX, np.asarray(g_j[0]), rtol=1e-11,
                               atol=1e-14)
    np.testing.assert_allclose(gp, np.asarray(g_j[1]), rtol=1e-11,
                               atol=1e-14)


@pytest.mark.parametrize("disc", ["trapezoid", "SimpsonHermite"])
def test_action_pallas_matches(disc):
    """make_action_pallas against the JAX package's (interpret mode) and
    against the port's autograd action: A, ME, FE and the gradient, 1e-12
    in f64."""
    sj, st, rng = _specs(disc, 23 if disc == "SimpsonHermite" else 33)
    XP = rng.normal(size=(2, st.n_dof))
    _, parts_j = fe_pallas.make_action_pallas(sj, block_n=8)
    act_j = fe_pallas.make_action_pallas(sj, block_n=8)[0]
    act, parts = fe.make_action_pallas(st, block_n=8, device=CPU)
    assert act.engine == "pallas"
    act_x, parts_x = make_action(st, device=CPU)
    XPt = torch.tensor(XP)
    got = [p.numpy() for p in parts(XPt, 1e-3)]
    for b in range(2):
        want = [float(v) for v in parts_j(jnp.asarray(XP[b]), 1e-3)]
        np.testing.assert_allclose([g[b] for g in got], want, rtol=1e-12)
    np.testing.assert_allclose(
        got, [p.numpy() for p in parts_x(XPt, 1e-3)], rtol=1e-12)
    x = XPt.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(act(x, 1e-3).sum(), x)
    x2 = XPt.clone().requires_grad_(True)
    (g_x,) = torch.autograd.grad(act_x(x2, 1e-3).sum(), x2)
    g_j = np.stack([np.asarray(jax.grad(act_j)(jnp.asarray(XP[b]), 1e-3))
                    for b in range(2)])
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(g.numpy(), g_x.numpy(), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("disc", ["euler", "SimpsonHermite"])
def test_backward_options_and_rf_gradient(disc):
    """pallas_backward=False (autograd of the plain model error) gives the
    hand adjoint's gradient; rf's gradient is FE/rf for a scalar rf and
    the plain model error's for an (N_f-1, D) rf, as in the reference; F
    fixed (no pest) runs too."""
    _, st, rng = _specs(disc, 29 if disc == "euler" else 23)
    X = rng.normal(size=(2, st.N_f, st.D))
    pest = np.array([[7.5], [8.5]])
    rf = _rf("diag", st, rng)
    a = _port_fe(st, X, pest, rf)
    b = _port_fe(st, X, pest, rf, pallas_backward=False)
    for u, w in zip(a, b):
        np.testing.assert_allclose(u, w, rtol=1e-12, atol=1e-14)
    f = fe.make_fe_pallas(st, block_n=8, device=CPU)
    Xt, pt = torch.tensor(X), torch.tensor(pest)
    rs = torch.tensor(2e-3, dtype=torch.float64, requires_grad=True)
    v = f(Xt, pt, rs)
    (g,) = torch.autograd.grad(v.sum(), rs)
    np.testing.assert_allclose(float(g), float(v.detach().sum()) / 2e-3,
                               rtol=1e-12)
    rd = torch.tensor(rf, requires_grad=True)
    (g,) = torch.autograd.grad(f(Xt, pt, rd).sum(), rd)
    sp = fe._action.device_spec(st, CPU, torch.float64)
    rd2 = torch.tensor(rf, requires_grad=True)
    ref = fe._action.model_error(sp, Xt, fe._action.merge_params(sp, pt),
                                 rd2)
    (g_r,) = torch.autograd.grad(ref.sum(), rd2)
    np.testing.assert_allclose(g.numpy(), g_r.numpy(), rtol=1e-12)
    st_fixed = dataclasses.replace(st, pidx=())
    v_fixed = fe.make_fe_pallas(st_fixed, block_n=8, device=CPU)(
        Xt, torch.zeros(2, 0, dtype=torch.float64), 1e-2)
    v_est = f(Xt, torch.full((2, 1), 8.17, dtype=torch.float64), 1e-2)
    np.testing.assert_allclose(v_fixed.numpy(), v_est.numpy(), rtol=1e-14)


def test_blocks_and_envelope():
    """Rows a block: for the one-step discs, as under Hermite–Simpson, the
    grid rule's rows from the batch over the SMs, at most 256 pairs a
    block (D=100: one row a block at B=1, two at B=64; config #5's width
    one row; D=6 at B=64 seven rows), the value-only and the fused
    launch alike; under Hermite–Simpson the grid rule's intervals (config
    #2, D=100: one interval a block at B=1, two at B=8); the plain
    partials are (B, n_blocks) and sum to FE·norm; the envelope's
    shared-memory edges (one interval a block of Lorenz-96 in f64 under
    Hermite–Simpson, one row a block under the trapezoid rule) and the
    kernels' wrappers, which take CUDA tensors only."""
    for kern in ("onestep_fwd", "onestep_vag"):
        assert fe.rows_per_block(kern, 240, 100, 64) == 1
        assert fe.rows_per_block(kern, 240, 100, 64, B=64) == 2
        assert fe.rows_per_block(kern, 161, 400, 64) == 1
        assert fe.rows_per_block(kern, 28, 6, 512, B=64) == 7
    assert fe.rows_per_block("sh_fwd", 120, 100, 64) == 1
    assert fe.rows_per_block("sh_vag", 120, 100, 64, B=8) == 2
    _, st, rng = _specs("SimpsonHermite", 23)
    for D, ok in ((3624, True), (3625, False)):
        wide = dataclasses.replace(st, D=D)
        assert fe.fe_kernel_supported(wide, 0.0, torch.float64) == ok
    _, st1, _ = _specs("trapezoid", 23)
    for D, ok in ((5798, True), (5799, False)):
        wide = dataclasses.replace(st1, D=D)
        assert fe.fe_kernel_supported(wide, 0.0, torch.float64) == ok
    c = fe.fe_consts(st, torch.float64, CPU, block_n=8)
    c = dataclasses.replace(c, n_sm=1)
    assert (c.M, c.n_blocks(2), c.n_blocks(2)) == (22, 3, 3)
    X = torch.tensor(rng.normal(size=(2, st.N_f, st.D)))
    pest = torch.tensor([[7.5], [8.0]])
    parts = fe.sh_fwd_reference(X, pest, 1e-2, c)
    assert parts.shape == (2, 3)
    sp = fe._action.device_spec(st, CPU, torch.float64)
    me = fe._action.model_error(sp, X, fe._action.merge_params(sp, pest),
                                1e-2)
    np.testing.assert_allclose((parts.sum(1) / c.norm).numpy(), me.numpy(),
                               rtol=1e-13)
    for kern in (fe.sh_fwd_kernel, fe.sh_vag_kernel):
        with pytest.raises(ValueError):
            kern(X, pest, 1e-2, c)
    for kern in (fe.onestep_fwd_kernel, fe.onestep_vag_kernel):
        with pytest.raises(ValueError):
            kern(X, pest, 1e-2, c)


def test_select_action_pallas_policy(monkeypatch):
    """engine='pallas': K6 on Lorenz-96; ValueError where the reference's
    fe_supported fails (time-dependent parameters, a non-uniform grid);
    NotImplementedError naming ROADMAP.md where the reference runs K6 but
    the port's envelope does not hold (another model; Lorenz-96 with a
    stimulus, the condition named).
    engine='auto' decided as on the card: K1 where the reference's
    ag_supported holds, K6 where it fails and pallas_preferred holds."""
    _, st, rng = _specs("SimpsonHermite", 23)
    for dt in (torch.float32, torch.float64):
        act, _ = fe.select_action(st, 1e-2, engine="pallas", dtype=dt,
                                  device="cpu")
        assert act.engine == "pallas"
    N = 9
    t = 0.025 * np.arange(N)
    Y = rng.normal(size=(N, 2))
    st_tdp = build_spec(lorenz96, 6, Y, t, [0, 2], 4.0,
                        P=np.full((N, 1), 8.0), pidx=[0])
    assert st_tdp.time_dep_p
    bent = dataclasses.replace(st, t_f=np.asarray(st.t_f) ** 1.5)
    for bad in (st_tdp, bent):
        with pytest.raises(ValueError, match="pallas"):
            fe.select_action(bad, 1e-2, engine="pallas", device="cpu")
    def user_f(t, x, p):
        return lorenz63(t, x, p) - x

    st_user = build_spec(user_f, 3, Y, t, [0, 2], 4.0,
                         P=np.array([10.0, 28.0, 8 / 3]), pidx=[0])
    stim = build_spec(lorenz96, 6, Y, t, [0, 2], 4.0, P=np.array([8.0]),
                      pidx=[0], stim=np.ones((N, 1)))
    for bad, item in ((st_user, "§2a item 3"), (stim, "with a stimulus")):
        with pytest.raises(NotImplementedError, match=item):
            fe.select_action(bad, 1e-2, engine="pallas", device="cpu")
    # engine='auto' as the card decides it (the actions are built lazily,
    # so nothing touches the card here)
    monkeypatch.setattr(fe, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    Y5 = np.zeros((5, 2))
    t5 = 0.025 * np.arange(5)

    def big(disc="trapezoid", RM=1.0, f=lorenz96):
        return build_spec(f, 256, Y5, t5, (0, 1), RM, P=np.array([8.0]),
                          pidx=[0], disc=disc)

    assert fe.reference_ag_supported(big(), 0.01)
    assert fe.ag_preferred(big("euler"), 0.01)
    assert not fe.pallas_preferred(big("SimpsonHermite"), 0.01)
    # RM (N_data, L, L): the reference's ag_supported fails, K6 runs it
    rm3 = np.broadcast_to(np.eye(2), (5, 2, 2)).copy()
    assert not fe.reference_ag_supported(big(RM=rm3), 0.01)
    assert fe.pallas_preferred(big(RM=rm3), 0.01)
    act, _ = fe.select_action(big(RM=rm3), 0.01)
    assert act.engine == "pallas"
    assert not fe.pallas_preferred(big(RM=rm3), 0.01, torch.float64)

    def other(t, x, p):
        return -x + p[..., 0:1]

    with pytest.raises(NotImplementedError, match="K6"):
        fe.select_action(big(RM=rm3, f=other), 0.01)


def _sh_twin(N_data=9, D=6, seed=4):
    rng = np.random.default_rng(seed)
    t = 0.05 * np.arange(N_data)
    Y = 2.0 + rng.normal(size=(N_data, 3))
    X0 = rng.uniform(-3, 3, size=(N_data, D))
    return X0, Y, t


def test_facade_pallas_matches_jax():
    """The facade with engine='pallas' on a small Hermite–Simpson problem
    (D=6, N_data=9, three f64 rungs, maxiter 20), the port's plain K6 on
    the CPU against the JAX facade's Pallas kernels in interpret mode:
    nfev exact, A within 1e-10."""
    X0, Y, t = _sh_twin()
    kw = dict(alpha=2.0, beta_array=np.arange(3), RM=4.0, RF0=0.5,
              Lidx=[0, 2, 4], Pidx=[0], disc="SimpsonHermite",
              opt_args=dict(maxiter=20), dtype=np.float64, engine="pallas")
    out = {}
    for nm, mod, f, extra in (
            ("jax", varanneal_tpu, lorenz96_jax, {}),
            ("port", varanneal_tpu_torch, lorenz96, dict(device="cpu"))):
        ann = mod.Annealer(**extra)
        ann.set_model(f, 6)
        ann.set_data(Y, t=t)
        ann.anneal(X0, np.array([7.0]), **kw)
        out[nm] = ann
    aj, ap = out["jax"], out["port"]
    np.testing.assert_array_equal(ap.nfev_array, aj.nfev_array)
    assert np.all(ap.nfev_array > 1)
    np.testing.assert_allclose(ap.A_array, aj.A_array, rtol=1e-10)
    np.testing.assert_array_equal(ap.exitflags, aj.exitflags)


def _near_truth(N_data=11, D=5, seed=9):
    """A Lorenz-96 twin (tests/test_ladder_integration.py's) and initial
    paths near its truth: with rf0 = RM each rung is a well-posed problem
    that two f64 implementations solve to the same minimum (phase 4 of
    chip_smoke.py)."""
    traj, Y, t, rng = make_twin(D=D, N_data=N_data, seed=seed)
    return traj, Y, t, rng, 1.0 / 0.4 ** 2


def test_runner_engine_pallas(tmp_path):
    """``python -m varanneal_tpu_torch`` with ``"engine": "pallas"`` on the
    CPU in f64 (run in process; torch's default dtype restored after):
    the three files, and records within 1e-8 of A of the same config with
    ``"engine": "xla"``, every rung solved to pgtol from near the twin's
    truth."""
    traj, Y, t, rng, RM = _near_truth()
    N, D = traj.shape
    np.save(tmp_path / "data.npy", np.column_stack([t, Y]))
    np.save(tmp_path / "x0.npy", traj + 0.3 * rng.normal(size=traj.shape))
    ae = {}
    old = torch.get_default_dtype()
    try:
        for engine in ("pallas", "xla"):
            cfg = dict(model={"name": "lorenz96", "D": D},
                       data={"file": str(tmp_path / "data.npy")},
                       X0=str(tmp_path / "x0.npy"), P0=[8.0],
                       out=str(tmp_path / engine), alpha=2.0,
                       beta_array={"stop": 4}, RM=RM, RF0=RM,
                       Lidx=[0, 1, 3], Pidx=[0], engine=engine,
                       opt_args={"maxiter": 2000, "gtol": 1e-8, "ftol": 0.0})
            path = tmp_path / f"{engine}.json"
            path.write_text(json.dumps(cfg))
            assert runner.main([str(path), "--device", "cpu"]) == 0
            ae[engine] = np.loadtxt(tmp_path / f"{engine}_action_errors.dat")
            assert np.load(tmp_path / f"{engine}_paths.npy").shape == (
                4, N, D + 1)
    finally:
        torch.set_default_dtype(old)
    assert ae["pallas"].shape == (4, 4) and np.all(np.isfinite(ae["pallas"]))
    scale = 1e-8 * np.abs(ae["xla"][:, 1:2])
    assert np.all(np.abs(ae["pallas"][:, 1:] - ae["xla"][:, 1:]) <= scale)


def test_batched_checkpointed_ladder(tmp_path):
    """The ensemble's path (run_ladder_checkpointed with batched=True, a
    checkpoint every 2 rungs) through K6's plain version and through the
    autograd action, f64, three Hermite–Simpson members from near the
    twin's truth, rf0 = RM, every rung solved to pgtol: A within 1e-8 at
    every rung, the same exit codes."""
    traj, Y, t, rng, RM = _near_truth()
    st = build_spec(lorenz96, 5, Y, t, [0, 1, 3], RM,
                    disc="SimpsonHermite", P=np.array([8.17]), pidx=[0])
    xp0 = torch.tensor(np.stack([pack(st, _insert_midpoints(
        traj + 0.3 * rng.normal(size=traj.shape)), np.array([8.0]))
        for _ in range(3)]))
    opts = LBFGSOptions(maxiter=2000, pgtol=1e-8, ftol=0.0)
    res = {}
    for nm, mk in (("pallas", fe.make_action_pallas), ("xla", make_action)):
        act, parts = mk(st, device=CPU)
        res[nm] = run_ladder_checkpointed(
            act, parts, xp0, np.arange(4), RM, 2.0, opts=opts,
            batched=True, ckpt_path=str(tmp_path / f"{nm}.npz"),
            save_every=2, device=CPU)
    a, b = res["pallas"], res["xla"]
    assert tuple(a.A.shape) == (3, 4)
    assert torch.equal(a.status, b.status) and bool((a.status == 0).all())
    np.testing.assert_array_less(np.abs((a.A - b.A).numpy()),
                                 1e-8 * np.abs(b.A.numpy()))
