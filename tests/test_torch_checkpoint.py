"""The port's checkpointed ladder (varanneal_tpu_torch/anneal/checkpoint.py,
with anneal/ladder.aggregate_repeats and LadderResult.snapshot) on the
flat and batched cases of tests/test_checkpoint.py, in f64 on the CPU:
an interrupted run resumes bit-identically, a checkpoint of another
ladder or other metadata is ignored, per-member boxes hold, repeats
aggregate to the expanded ladder, the snapshot is the exact state,
converged repeats are skipped at no cost to the result, and the facade
takes repeats and a snapshot. The checkpoint file is the reference's
format, so a ladder checkpointed halfway by one package resumes in the
other: the remaining rungs' records match the other package's
uninterrupted run (counts exact, A within 1e-8 relative at rungs both
solve to pgtol; every such rung here)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from varanneal_tpu.anneal.checkpoint import \
    run_ladder_checkpointed as run_ladder_checkpointed_jax
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax

import varanneal_tpu_torch
from varanneal_tpu_torch.anneal import run_ladder, run_ladder_checkpointed
from varanneal_tpu_torch.anneal.checkpoint import FLAT_TREEDEF
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, make_action
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.parallel import random_ensemble_inits
from tests.test_ladder_integration import make_twin

CPU = dict(device="cpu")


def _spec(seed=0):
    rng = np.random.default_rng(seed)
    D, N_data = 6, 13
    t = 0.025 * np.arange(N_data)
    Y = rng.normal(size=(N_data, 3))
    return build_spec(lorenz96, D, Y, t, [0, 2, 4], 4.0, disc="trapezoid",
                      P=np.array([8.0]), pidx=[0])


def _setup(seed=0):
    spec = _spec(seed)
    action, parts = make_action(spec, **CPU)
    xp0 = torch.tensor(random_ensemble_inits(spec, 1, seed=1)[0])
    return action, parts, xp0


def _as_full(path, n, betas):
    """Patch a partial run's checkpoint to the full ladder's metadata, as a
    preempted full run would have written it."""
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    payload["n_beta"] = np.asarray(n)
    payload["betas"] = betas
    np.savez(path, **payload)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_bit_identical(tmp_path):
    action, parts, xp0 = _setup()
    betas = np.arange(11.0)             # ragged tail: chunks 4+4+3
    opts = LBFGSOptions(maxiter=20, pgtol=1e-9)
    kw = dict(ckpt_path=str(tmp_path / "ck.npz"), save_every=4, opts=opts,
              store_paths=True, **CPU)
    full = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                   resume=False, **kw)
    kw2 = dict(kw, ckpt_path=str(tmp_path / "ck2.npz"))
    run_ladder_checkpointed(action, parts, xp0, betas[:8], 1e-4, 1.7,
                            resume=False, **kw2)
    _as_full(kw2["ckpt_path"], 11, betas)
    with np.load(kw2["ckpt_path"]) as z:
        assert str(z["treedef"]) == FLAT_TREEDEF and int(z["next_idx"]) == 8
    resumed = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                      resume=True, **kw2)
    for k in ("A", "XP", "paths", "niter", "nfev", "status"):
        _eq(getattr(resumed, k), getattr(full, k))
    # and the same records as the plain ladder in one go
    plain = run_ladder(action, parts, xp0, betas, 1e-4, 1.7, opts=opts,
                       **CPU)
    _eq(full.A, plain.A)
    _eq(full.XP, plain.XP)


def test_checkpoint_mismatch_starts_fresh(tmp_path):
    action, parts, xp0 = _setup()
    opts = LBFGSOptions(maxiter=10)
    p = str(tmp_path / "ck.npz")
    run_ladder_checkpointed(action, parts, xp0, np.arange(4.0), 1e-4, 1.7,
                            ckpt_path=p, save_every=2, opts=opts,
                            resume=False, **CPU)
    res = run_ladder_checkpointed(action, parts, xp0, np.arange(6.0),
                                  1e-4, 1.7, ckpt_path=p, save_every=2,
                                  opts=opts, resume=True, **CPU)
    assert len(res.A) == 6
    assert bool(torch.isfinite(res.A).all())


def test_checkpoint_batched_ensemble_resume(tmp_path):
    action, parts, _ = _setup()
    spec = _spec()
    B = 4
    xp0 = torch.tensor(random_ensemble_inits(spec, B, seed=2))
    betas = np.arange(6.0)
    opts = LBFGSOptions(maxiter=15, pgtol=1e-9)
    kw = dict(save_every=2, opts=opts, store_paths=False, batched=True,
              **CPU)
    full = run_ladder_checkpointed(
        action, parts, xp0, betas, 1e-4, 1.7, resume=False,
        ckpt_path=str(tmp_path / "b.npz"), **kw)
    assert full.A.shape == (B, 6)
    p2 = str(tmp_path / "b2.npz")
    run_ladder_checkpointed(action, parts, xp0, betas[:4], 1e-4, 1.7,
                            resume=False, ckpt_path=p2, **kw)
    _as_full(p2, 6, betas)
    resumed = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                      resume=True, ckpt_path=p2, **kw)
    _eq(resumed.A, full.A)
    _eq(resumed.XP, full.XP)


def test_batched_bounds_per_member(tmp_path):
    """Each member is solved in its own box and lands where the
    single-member ladder in that box lands; resume stays bit-identical."""
    spec = _spec()
    action, parts = make_action(spec, **CPU)
    B = 3
    xp0 = random_ensemble_inits(spec, B, seed=2)
    n_dof = xp0.shape[1]
    pboxes = [(7.5, 7.6), (8.2, 8.4), (6.0, 6.5)]
    lo = np.full((B, n_dof), -30.0)
    hi = np.full((B, n_dof), 30.0)
    for b, (pl, ph) in enumerate(pboxes):
        lo[b, -1], hi[b, -1] = pl, ph
    xp0 = torch.tensor(np.clip(xp0, lo, hi))
    betas = np.arange(5.0)
    opts = LBFGSOptions(maxiter=15, pgtol=1e-9)
    kw = dict(save_every=2, opts=opts, store_paths=False, batched=True,
              batched_bounds=True, lower=lo, upper=hi, **CPU)
    res = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                  resume=False,
                                  ckpt_path=str(tmp_path / "pb.npz"), **kw)
    assert res.A.shape == (B, 5)
    XP = res.XP.numpy()
    for b, (pl, ph) in enumerate(pboxes):
        assert pl <= XP[b, -1] <= ph
        single = run_ladder(action, parts, xp0[b], betas, 1e-4, 1.7,
                            lower=lo[b], upper=hi[b], opts=opts,
                            store_paths=False, **CPU)
        # a batch of three and a batch of one take other matrix-product
        # paths, whose round-off the nonconvex solve amplifies: the same
        # basin, at tests/test_checkpoint.py's tolerances
        np.testing.assert_allclose(XP[b], single.XP.numpy(), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(res.A[b].numpy(), single.A.numpy(),
                                   rtol=1e-4)
    p2 = str(tmp_path / "pb2.npz")
    run_ladder_checkpointed(action, parts, xp0, betas[:4], 1e-4, 1.7,
                            resume=False, ckpt_path=p2, **kw)
    _as_full(p2, 5, betas)
    resumed = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                      resume=True, ckpt_path=p2, **kw)
    _eq(resumed.A, res.A)
    _eq(resumed.XP, res.XP)
    with pytest.raises(ValueError):
        run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                batched_bounds=True, opts=opts, **CPU)


def test_repeats_aggregation_matches_expanded_ladder():
    action, parts, xp0 = _setup()
    betas = np.arange(5.0)
    opts = LBFGSOptions(maxiter=8, pgtol=1e-12)   # MAXITER exits, so the
    # repeats change the iterate
    rep = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                  save_every=3, opts=opts,
                                  store_paths=True, repeats=3, **CPU)
    exp = run_ladder_checkpointed(action, parts, xp0, np.repeat(betas, 3),
                                  1e-4, 1.7, save_every=3, opts=opts,
                                  store_paths=True, **CPU)
    assert rep.A.shape == (5,) and rep.paths.shape == (5, xp0.shape[0])
    _eq(rep.XP, exp.XP)
    _eq(rep.A, exp.A.reshape(5, 3)[:, -1])
    _eq(rep.paths, exp.paths.reshape(5, 3, -1)[:, -1])
    _eq(rep.nfev, exp.nfev.reshape(5, 3).sum(1))
    _eq(rep.niter, exp.niter.reshape(5, 3).sum(1))
    assert bool(torch.all(rep.A <= exp.A.reshape(5, 3)[:, 0] + 1e-12))


def test_snapshot_beta_exact_state(tmp_path):
    action, parts, xp0 = _setup()
    betas = np.arange(7.0)
    opts = LBFGSOptions(maxiter=15, pgtol=1e-9)
    kw = dict(save_every=2, opts=opts, store_paths=False, **CPU)
    res = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                  snapshot_beta=3, **kw)
    ref = run_ladder_checkpointed(action, parts, xp0, betas[:3], 1e-4, 1.7,
                                  **kw)
    assert res.snapshot is not None
    _eq(res.snapshot, ref.XP)
    p = str(tmp_path / "s.npz")
    run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                            ckpt_path=p, snapshot_beta=3, resume=False, **kw)
    res2 = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                   ckpt_path=p, snapshot_beta=3,
                                   resume=True, **kw)
    _eq(res2.snapshot, res.snapshot)
    with pytest.raises(ValueError):
        run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                snapshot_beta=8, **kw)


def test_repeats_with_snapshot_and_batch():
    action, parts, _ = _setup()
    xp0 = torch.tensor(random_ensemble_inits(_spec(), 3, seed=2))
    betas = np.arange(4.0)
    opts = LBFGSOptions(maxiter=6, pgtol=1e-12)
    kw = dict(save_every=3, opts=opts, store_paths=False, batched=True,
              **CPU)
    res = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                  repeats=2, snapshot_beta=2, **kw)
    assert res.A.shape == (3, 4)
    assert res.snapshot.shape == xp0.shape
    ref = run_ladder_checkpointed(action, parts, xp0,
                                  np.repeat(betas[:2], 2), 1e-4, 1.7, **kw)
    _eq(res.snapshot, ref.XP)


def test_meta_mismatch_starts_fresh(tmp_path, capsys):
    action, parts, xp0 = _setup()
    betas = np.arange(4.0)
    kw = dict(ckpt_path=str(tmp_path / "m.npz"), save_every=2,
              opts=LBFGSOptions(maxiter=10), store_paths=False, **CPU)
    run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                            resume=False,
                            meta=dict(seed=3, gate_rf_scale=1000.0), **kw)
    run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                            resume=True, verbose=True,
                            meta=dict(seed=3, gate_rf_scale=1000.0), **kw)
    assert "resuming at dispatch index 4" in capsys.readouterr().out
    run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                            resume=True, verbose=True,
                            meta=dict(seed=4, gate_rf_scale=1000.0), **kw)
    assert "starting fresh" in capsys.readouterr().out


def test_skip_converged_repeats_identical_and_cheaper():
    action, parts, xp0 = _setup()
    betas = np.arange(4.0)
    kw = dict(save_every=1, opts=LBFGSOptions(maxiter=400, pgtol=1e-5,
                                              ftol=0.0),
              store_paths=False, **CPU)
    skip = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                   repeats=4, **kw)
    legacy = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                     repeats=4, skip_converged_repeats=False,
                                     **kw)
    one = run_ladder_checkpointed(action, parts, xp0, betas, 1e-4, 1.7,
                                  repeats=1, **kw)
    assert bool(torch.all(skip.status == 0))
    for k in ("XP", "A", "pgnorm"):
        _eq(getattr(skip, k), getattr(legacy, k))
    _eq(skip.niter, one.niter)
    _eq(skip.nfev, one.nfev)
    assert bool(torch.all(legacy.nfev >= skip.nfev))


def test_skip_converged_repeats_batched_checkpoint_resume(tmp_path):
    action, parts, xp0 = _setup()
    xp0b = torch.stack([xp0, xp0 + 0.01])
    betas = np.arange(3.0)
    kw = dict(save_every=1, opts=LBFGSOptions(maxiter=400, pgtol=1e-5,
                                              ftol=0.0),
              store_paths=False, repeats=3, batched=True, **CPU)
    full = run_ladder_checkpointed(action, parts, xp0b, betas, 1e-4, 1.7,
                                   **kw)
    ck = str(tmp_path / "skip.npz")
    run_ladder_checkpointed(action, parts, xp0b, betas[:2], 1e-4, 1.7,
                            ckpt_path=ck, **kw)
    resumed = run_ladder_checkpointed(action, parts, xp0b, betas, 1e-4,
                                      1.7, ckpt_path=ck, **kw)
    _eq(full.XP, resumed.XP)
    _eq(full.A, resumed.A)


def test_tree_decision_variables_wait():
    action, parts, xp0 = _setup()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_ladder_checkpointed(action, parts, {"X": xp0, "pest": xp0[:1]},
                                np.arange(2.0), 1e-4, 1.7, **CPU)


def test_facade_repeats_snapshot():
    rng = np.random.default_rng(2)
    D, N_data = 6, 13
    t = 0.025 * np.arange(N_data)
    Y = rng.normal(size=(N_data, 3))
    X0 = rng.normal(size=(N_data, D))
    out = {}
    for nm, mod, f, ctor in (
            ("jax", __import__("varanneal_tpu"), lorenz96_jax, {}),
            ("port", varanneal_tpu_torch, lorenz96, CPU)):
        ann = mod.Annealer(**ctor)
        ann.set_model(f, D)
        ann.set_data(Y, t=t)
        ann.anneal(X0, np.array([8.0]), 1.7, np.arange(5), 4.0, 1e-4,
                   [0, 2, 4], [0], opt_args=dict(maxiter=10),
                   repeats=2, snapshot_beta=3, engine="xla",
                   dtype=np.float64)
        out[nm] = ann
    ann = out["port"]
    assert ann.A_array.shape == (5,)
    assert ann.XP_snapshot is not None
    assert np.asarray(ann.XP_snapshot).shape == ann.XP_final.shape
    assert np.all(np.isfinite(ann.A_array))
    # short f64 solves of the same arithmetic: the same counts and, to
    # round-off, the same actions and snapshot as the JAX facade
    np.testing.assert_array_equal(ann.nfev_array, out["jax"].nfev_array)
    np.testing.assert_allclose(ann.A_array, out["jax"].A_array, rtol=1e-10)
    np.testing.assert_allclose(ann.XP_snapshot, out["jax"].XP_snapshot,
                               rtol=1e-9, atol=1e-9)


# ---- cross-package resume ---------------------------------------------------

BETAS_X = np.arange(8.0)
# every rung is solved to pgtol 1e-5 (ftol off) from the previous rung's
# minimizer: short solves, whose iterates the two f64 implementations
# share to round-off, so counts are exact and every rung is converged
KW_X = dict(maxiter=20000, pgtol=1e-5, ftol=0.0)


@pytest.fixture(scope="module")
def cross():
    D, N_data, Lidx = 5, 21, (0, 1, 3)
    _, Y, t, rng = make_twin(D=D, N_data=N_data, Lidx=Lidx)
    kw = dict(disc="trapezoid", P=np.array([4.0]), pidx=[0])
    sj = build_spec_jax(lorenz96_jax, D, Y, t, Lidx, 1.0 / 0.4 ** 2, **kw)
    st = build_spec(lorenz96, D, Y, t, Lidx, 1.0 / 0.4 ** 2, **kw)
    X = np.full((N_data, D), Y.mean()) + 0.5 * rng.normal(size=(N_data, D))
    X[:, list(Lidx)] = Y
    x0 = np.concatenate([X.ravel(), [4.0]])
    act_j, parts_j = make_action_jax(sj)
    act_t, parts_t = make_action(st, **CPU)

    def jax_run(xp, betas, **k):
        return run_ladder_checkpointed_jax(
            act_j, parts_j, jnp.asarray(xp), betas, 1e-3, 1.9,
            save_every=2, opts=OptsJax(**KW_X), **k)

    def port_run(xp, betas, **k):
        return run_ladder_checkpointed(
            act_t, parts_t, torch.tensor(xp), betas, 1e-3, 1.9,
            save_every=2, opts=LBFGSOptions(**KW_X), **CPU, **k)

    return dict(x0=x0, jax=jax_run, port=port_run,
                full_jax=jax_run(x0, BETAS_X), full_port=port_run(x0, BETAS_X))


def _records(r):
    return {k: np.asarray(getattr(r, k)) for k in
            ("A", "niter", "nfev", "status")}


def _assert_rest_matches(res, ref, start):
    got, want = _records(res), _records(ref)
    for k in ("niter", "nfev", "status"):
        np.testing.assert_array_equal(got[k][start:], want[k][start:])
    conv = want["status"][start:] <= 1
    assert conv.all()
    rel = np.abs(got["A"][start:] - want["A"][start:]) / np.abs(
        want["A"][start:])
    assert rel[conv].max() <= 1e-8, rel


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_cross_package_resume(cross, writer, reader, tmp_path):
    """Four of eight rungs checkpointed by ``writer``; ``reader`` resumes
    the file and runs rungs 4..7, which must match ``writer``'s
    uninterrupted run; rungs 0..3 come back from the file unchanged."""
    p = str(tmp_path / "x.npz")
    cross[writer](cross["x0"], BETAS_X[:4], ckpt_path=p)
    _as_full(p, len(BETAS_X), BETAS_X)
    res = cross[reader](cross["x0"], BETAS_X, ckpt_path=p, resume=True)
    full = cross[f"full_{writer}"]
    got, want = _records(res), _records(full)
    for k in got:
        np.testing.assert_array_equal(got[k][:4], want[k][:4])
    _assert_rest_matches(res, full, 4)
    with np.load(p) as z:
        assert int(z["next_idx"]) == len(BETAS_X)
