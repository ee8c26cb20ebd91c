"""The port's va_nnet path (varanneal_tpu_torch/nnet.py, va_nnet.py)
against the JAX package's (varanneal_tpu/nnet.py) on the CPU.

The action and its gradient match to 1e-12 in f64 over clamp_input × rf
kind × hidden activation, batched and member by member; ``pack``/
``unravel`` are ``ravel_pytree``'s flat vector bit for bit.

The nnet action is over-parameterized, and two f64 implementations'
L-BFGS iterates part on it from round-off (tests/test_nnet_ensemble.py
says so for the reference alone): from the same start, config #4's
``--small`` rung 0 agrees to 1e-15 after two iterations, 1e-13 after
three, 1e-7 after five and ~1e-3 after twelve, and the two pgtol-1e-9
minimizers end at actions ~4e-7 apart by a few per cent. The JAX package
parts from itself at the same rate from a start moved by one ulp
(2.8e-8 after five iterations, 4.1e-5 after eight), which
``test_jax_ladder_parts_from_itself`` holds. So the facades are compared
rung by rung: each rung starts both packages from the JAX package's
minimizer of the rung before and takes three iterations, and the counts
must agree exactly and A to 1e-8. Whole ladders are held to
what is stable on this landscape: every rung converged, the fit, and
the action's level.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.flatten_util import ravel_pytree

from varanneal_tpu import nnet as nnet_jax
from varanneal_tpu.anneal import run_ladder as run_ladder_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax

import varanneal_tpu_torch
from varanneal_tpu_torch import nnet, va_nnet
from varanneal_tpu_torch.anneal import run_ladder
from varanneal_tpu_torch.opt import LBFGSOptions

CPU = dict(device="cpu")
ACTS = {"tanh": (jnp.tanh, torch.tanh),
        "sigmoid": (jax.nn.sigmoid, torch.sigmoid),
        "relu": (jax.nn.relu, torch.relu),
        "linear": (lambda z: z, lambda z: z)}


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _problem(seed=0, structure=(3, 5, 4, 2), M=7):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(M, structure[0]))
    Y = rng.normal(size=(M, structure[-1]))
    X = [rng.normal(size=(M, n)) for n in structure]
    W = [rng.normal(size=(structure[i + 1], structure[i]))
         for i in range(len(structure) - 1)]
    b = [rng.normal(size=(structure[i + 1],))
         for i in range(len(structure) - 1)]
    return rng, U, Y, X, W, b


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("rf_kind", ["scalar", "perlayer"])
@pytest.mark.parametrize("clamp_input", [False, True])
def test_action_and_grad_match_jax(clamp_input, rf_kind, act):
    """A, ME, FE and dA/dXP against nnet_action_factory and jax.grad in
    f64 to 1e-12 (relative; the gradient over its max|g|), the output
    linear, for each member of a batch of B = 3; and the batch against
    each member evaluated alone, to 1e-14 (the batched products take
    other BLAS paths, so not bit for bit)."""
    structure = (3, 5, 4, 2)
    rng, U, Y, X, W, b = _problem()
    rf = 0.37 if rf_kind == "scalar" else rng.uniform(0.1, 1.0, size=3)
    RM_in, RM_out = 2.0, rng.uniform(0.5, 2.0, size=2)
    gj, gt = ACTS[act]
    act_j, parts_j, pack_j, _ = nnet_jax.nnet_action_factory(
        structure, gj, lambda z: z, U, Y, RM_in, RM_out,
        clamp_input=clamp_input)
    act_t, parts_t, _, _ = nnet.nnet_action_factory(
        structure, gt, lambda z: z, U, Y, RM_in, RM_out,
        clamp_input=clamp_input, **CPU)
    Xd = X[1:] if clamp_input else X
    xp = np.asarray(pack_j({"X": Xd, "W": W, "b": b}))
    xps = np.stack([xp, xp + 0.1 * rng.normal(size=xp.shape),
                    xp - 0.2 * rng.normal(size=xp.shape)])
    rf_t = rf if np.ndim(rf) == 0 else torch.tensor(rf)
    XP = torch.tensor(xps, requires_grad=True)
    A, ME, FE = parts_t(XP, rf_t)
    (g,) = torch.autograd.grad(A.sum(), XP)
    for i in range(3):
        z = jnp.asarray(xps[i])
        want = [float(v) for v in parts_j(z, jnp.asarray(rf))]
        g_want = np.asarray(jax.grad(act_j)(z, jnp.asarray(rf)))
        for got, w in zip((A[i], ME[i], FE[i]), want):
            assert abs(float(got.detach()) - w) <= 1e-12 * abs(w)
        scale = np.abs(g_want).max()
        np.testing.assert_array_less(np.abs(g[i].numpy() - g_want),
                                     1e-12 * scale)
        one = torch.tensor(xps[i], requires_grad=True)
        A1 = act_t(one, rf_t)
        (g1,) = torch.autograd.grad(A1, one)
        assert A1.shape == ()
        assert abs(float(A1.detach()) - float(A[i].detach())) <= \
            1e-14 * abs(float(A1.detach()))
        np.testing.assert_array_less(np.abs(g1.numpy() - g[i].numpy()),
                                     1e-14 * scale)


@pytest.mark.parametrize("structure,M", [((3, 5, 4, 2), 7),
                                         ((2, 16, 16, 1), 128)])
@pytest.mark.parametrize("clamp_input", [False, True])
def test_pack_unravel_match_ravel_pytree(structure, M, clamp_input):
    """pack gives ravel_pytree's flat vector bit for bit (config #4's
    structure at M = 128: W at 0/32/288, X at 304/560/2,608/4,656, b at
    4,784/4,800/4,816), and unravel its leaves; batched unravel keeps the
    leading axis."""
    _, U, Y, X, W, b = _problem(1, structure, M)
    if clamp_input:
        X = X[1:]
    tree = {"X": X, "W": W, "b": b}
    flat_j, unravel_j = ravel_pytree(jax.tree_util.tree_map(jnp.asarray,
                                                            tree))
    _, _, pack, unravel = nnet.nnet_action_factory(
        structure, torch.tanh, lambda z: z, U, Y, 1.0, 1.0,
        clamp_input=clamp_input, **CPU)
    flat = pack(tree)
    assert flat.dtype == np.float64
    np.testing.assert_array_equal(flat, np.asarray(flat_j))
    got, want = unravel(flat), unravel_j(flat_j)
    for k in ("X", "W", "b"):
        for a, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, np.asarray(w))
    two = unravel(torch.tensor(np.stack([flat, -flat])))
    assert tuple(two["W"][0].shape) == (2,) + W[0].shape
    np.testing.assert_array_equal(two["X"][-1][1].numpy(), -X[-1])
    if structure == (2, 16, 16, 1) and not clamp_input:
        assert flat.shape == (4817,)
        sizes = [a.size for a in W] + [a.size for a in X] + [a.size
                                                             for a in b]
        assert list(np.cumsum([0] + sizes)[:-1]) == [
            0, 32, 288, 304, 560, 2608, 4656, 4784, 4800, 4816]


def test_forward_device(monkeypatch, f64):
    """nnet.forward runs on the device it is given: against the JAX
    package's forward in f64 to 1e-12 on the CPU when the CPU is asked
    for, a tensor there in torch's default dtype or the one passed;
    device=None means the CUDA card and raises without one."""
    structure = (3, 5, 4, 2)
    _, U, _, _, W, b = _problem()
    want = np.asarray(nnet_jax.forward(structure, jnp.tanh, lambda z: z,
                                       W, b, U))
    got = nnet.forward(structure, torch.tanh, lambda z: z, W, b, U, **CPU)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    assert nnet.forward(structure, torch.tanh, lambda z: z, W, b, U,
                        dtype=torch.float32, **CPU).dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nnet.forward(structure, torch.tanh, lambda z: z, W, b, U)


def _small_data(M=32):
    """examples/nnet_train.py's data: default_rng(11), the teacher map."""
    rng = np.random.default_rng(11)
    U = rng.uniform(-1, 1, size=(M, 2))
    Y = (np.sin(2.0 * U[:, :1]) * np.cos(1.5 * U[:, 1:])
         + 0.25 * U[:, :1] * U[:, 1:])
    U_test = rng.uniform(-1, 1, size=(64, 2))
    return U, Y, U_test


# examples/nnet_train.py --small: M = 32, 16 rungs, alpha 2, RM 1, RF0
# 1e-3, maxiter 1500, gtol 1e-9, seed 3
SMALL = dict(alpha=2.0, beta_array=np.arange(16), RM=1.0, RF0=1e-3,
             opt_args=dict(maxiter=1500, gtol=1e-9), seed=3)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    U, Y, U_test = _small_data()
    out = {}
    try:
        for nm, mod, ctor in (("jax", nnet_jax, {}), ("port", va_nnet, CPU)):
            ann = mod.Annealer(**ctor)
            ann.set_structure([2, 16, 16, 1])
            ann.set_activation("tanh")
            ann.set_input_data(U)
            ann.set_output_data(Y)
            ann.anneal(**SMALL)
            d = tmp_path_factory.mktemp(nm)
            files = {}
            for ext in (".npy", ".dat"):
                ann.save_weights(str(d / f"w{ext}"))
                ann.save_action_errors(str(d / f"ae{ext}"))
                files[ext] = [np.load(str(d / f"{k}{ext}")) if ext == ".npy"
                              else np.loadtxt(str(d / f"{k}{ext}"))
                              for k in ("w", "ae")]
            out[nm] = (ann, files)
    finally:
        torch.set_default_dtype(old)
    return U, Y, U_test, out


def _init_vector(mod, ctor, U, Y, dtype):
    """The facade's initial flat vector for SMALL's config: a one-rung
    run at maxiter 0 leaves it as the rung's minimizer."""
    ann = mod.Annealer(**ctor)
    ann.set_structure([2, 16, 16, 1])
    ann.set_activation("tanh")
    ann.set_input_data(U)
    ann.set_output_data(Y)
    ann.anneal(**dict(SMALL, beta_array=[0], opt_args=dict(maxiter=0),
                      dtype=dtype))
    return np.asarray(ann.minpaths[0])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_facade_initial_state_matches_jax(small, dtype):
    """The default init: the weights, the biases and X[0] = U bit for bit
    (the same default_rng(seed) draws); each layer's product in f64, then
    its activation in the run's dtype. XLA's f64 tanh and torch's differ
    in the last bits on ~58 % of arguments (by up to 5.6e-16), so the
    first hidden layer agrees to 2 ulps (f64) or 1 ulp (f32: the JAX
    package's x64 on takes its tanh in f64, rounded to f32 by pack; the
    port's in f32, as the JAX package's x64-off path forms it), and the
    layers after it, whose products carry those ulps, to 4 ulps of the
    layer's largest entry (measured: 1.5 and 2.5 in f64)."""
    U, Y, _, _ = small
    got = _init_vector(nnet, CPU, U, Y, dtype)
    want = _init_vector(nnet_jax, {}, U, Y, dtype)
    assert got.dtype == want.dtype == dtype and got.shape == (1457,)
    np.testing.assert_array_equal(got[:304], want[:304])        # W
    np.testing.assert_array_equal(got[-33:], want[-33:])        # b
    np.testing.assert_array_equal(got[304:368], want[304:368])  # X[0] = U
    x1 = slice(368, 880)
    ulps = 2 if dtype == np.float64 else 1
    assert np.all(np.abs(got[x1] - want[x1])
                  <= ulps * np.spacing(np.abs(want[x1])))
    for sl in (slice(880, 1392), slice(1392, 1424)):            # X[2], X[3]
        assert np.all(np.abs(got[sl] - want[sl])
                      <= 4 * np.spacing(np.abs(want[sl]).max()))


def test_facade_rung_by_rung_matches_jax(small, f64):
    """Each rung of the --small ladder from the JAX package's minimizer of
    the rung before (rung 0 from its init), three iterations of each
    package's L-BFGS on its own action: the same niter, nfev and status,
    A within 1e-8."""
    U, Y, _, out = small
    aj = out["jax"][0]
    act_j, parts_j, _, _ = nnet_jax.nnet_action_factory(
        (2, 16, 16, 1), jnp.tanh, lambda z: z, U, Y, 1.0, 1.0)
    act_t, parts_t, _, _ = nnet.nnet_action_factory(
        (2, 16, 16, 1), torch.tanh, lambda z: z, U, Y, 1.0, 1.0, **CPU)
    starts = np.concatenate([
        _init_vector(nnet_jax, {}, U, Y, np.float64)[None],
        aj.minpaths[:-1]])
    kw = dict(maxiter=3, pgtol=1e-9)
    fn = jax.jit(jax.vmap(lambda z, b: run_ladder_jax(
        act_j, parts_j, z, b[None], 1e-3, 2.0, opts=OptsJax(**kw),
        store_paths=False)))
    rj = fn(jnp.asarray(starts), jnp.arange(16.0))
    for k in range(16):
        rt = run_ladder(act_t, parts_t, torch.tensor(starts[k]),
                        np.array([float(k)]), 1e-3, 2.0,
                        opts=LBFGSOptions(**kw), store_paths=False, **CPU)
        for f in ("niter", "nfev", "status"):
            assert int(getattr(rt, f)[0]) == int(getattr(rj, f)[k, 0]), f
        a = float(rj.A[k, 0])
        assert abs(float(rt.A[0]) - a) <= 1e-8 * abs(a), (k, a)


@pytest.mark.parametrize("iters", [5, 8])
def test_jax_ladder_parts_from_itself(small, f64, iters):
    """The witness for the three-iteration comparison above: past three
    iterations the JAX package parts from itself, from the --small rung 0
    init moved by one ulp in every entry (``np.nextafter``), as the port
    parts from it. The same niter, nfev and status in all three runs; the
    JAX package's own spread in A over 1e-10 (measured: 2.8e-8 after
    five iterations, 4.1e-5 after eight); the port's spread from it
    within 10 times that (measured: 3.4e-8 and 5.1e-5)."""
    U, Y, _, _ = small
    act_j, parts_j, _, _ = nnet_jax.nnet_action_factory(
        (2, 16, 16, 1), jnp.tanh, lambda z: z, U, Y, 1.0, 1.0)
    act_t, parts_t, _, _ = nnet.nnet_action_factory(
        (2, 16, 16, 1), torch.tanh, lambda z: z, U, Y, 1.0, 1.0, **CPU)
    x0 = _init_vector(nnet_jax, {}, U, Y, np.float64)
    kw = dict(maxiter=iters, pgtol=1e-9)
    fn = jax.jit(lambda z: run_ladder_jax(
        act_j, parts_j, z, jnp.zeros(1), 1e-3, 2.0, opts=OptsJax(**kw),
        store_paths=False))
    rj, rj1 = fn(jnp.asarray(x0)), fn(jnp.asarray(np.nextafter(x0, np.inf)))
    rt = run_ladder(act_t, parts_t, torch.tensor(x0), np.zeros(1), 1e-3,
                    2.0, opts=LBFGSOptions(**kw), store_paths=False, **CPU)
    for f in ("niter", "nfev", "status"):
        assert int(getattr(rj1, f)[0]) == int(getattr(rj, f)[0]), f
        assert int(getattr(rt, f)[0]) == int(getattr(rj, f)[0]), f
    a = float(rj.A[0])
    d_jax = abs(float(rj1.A[0]) - a) / a
    d_port = abs(float(rt.A[0]) - a) / a
    assert d_jax > 1e-10, d_jax
    assert d_port <= 10 * d_jax, (d_port, d_jax)


def test_facade_ladder_levels_and_files(small, f64):
    """The whole --small ladders: every rung converged in both, FE/RF (the
    raw layer residual) collapsing, the fit of both within 20 % of each
    other and under 0.25 RMSE on the training and fresh inputs, predict
    the forward pass of the weights; the save helpers' layouts (weights
    W then b, one row; [β, A, ME, FE] rows with β exact)."""
    U, Y, U_test, out = small
    (aj, fj), (ap, fp) = out["jax"], out["port"]
    assert np.all(aj.exitflags == 0) and np.all(ap.exitflags == 0)
    assert ap.A_array.shape == (16,) and ap.A_array.dtype == np.float64
    resid = ap.fe_array / (1e-3 * 2.0 ** ap.beta_array)
    assert resid[-1] < 1e-3 * resid[0]
    for Uq in (U, U_test):
        pj, pp = aj.predict(Uq), ap.predict(Uq)
        assert pp.shape == pj.shape == (len(Uq), 1)
        Yq = (np.sin(2.0 * Uq[:, :1]) * np.cos(1.5 * Uq[:, 1:])
              + 0.25 * Uq[:, :1] * Uq[:, 1:])
        rj, rp = (np.sqrt(np.mean((p - Yq) ** 2)) for p in (pj, pp))
        assert rp < 0.25 and abs(rp - rj) <= 0.2 * rj, (rp, rj)
    W, b = ap.weights_at(-1)
    np.testing.assert_allclose(
        ap.predict(U), np.tanh(np.tanh(U @ W[0].T + b[0]) @ W[1].T + b[1])
        @ W[2].T + b[2], rtol=1e-12, atol=1e-14)
    Xs = ap.activations_at(-1)
    assert [x.shape for x in Xs] == [(32, 2), (32, 16), (32, 16), (32, 1)]
    for ext in (".npy", ".dat"):
        w_p, ae_p = fp[ext]
        w_j, ae_j = fj[ext]
        assert np.shape(w_p) in ((1, 337), (337,))
        assert np.shape(w_p) == np.shape(w_j)
        np.testing.assert_array_equal(np.ravel(w_p), np.concatenate(
            [w.ravel() for w in W] + [x.ravel() for x in b]))
        assert ae_p.shape == ae_j.shape == (16, 4)
        np.testing.assert_array_equal(ae_p[:, 0], ae_j[:, 0])
        np.testing.assert_array_equal(ae_p[:, 1], ap.A_array)


def test_clamped_input_and_bounds(f64):
    """tests/test_nnet.py::test_nnet_clamped_input_and_bounds through both
    facades: every weight of every rung in its box, X[0] exactly U, the
    records finite and the exit flags SciPy's codes in both. The actions
    are not compared rung by rung: the projection loop parts from
    round-off on this landscape as the unbounded one does (measured: up
    to a factor of 2 at some rungs, both at levels of ~1e-5)."""
    rng = np.random.default_rng(5)
    M = 12
    U = rng.normal(size=(M, 2))
    Y = (U[:, :1] * U[:, 1:]) + 0.1
    out = {}
    for nm, mod, ctor in (("jax", nnet_jax, {}), ("port", nnet, CPU)):
        ann = mod.Annealer(**ctor)
        ann.set_structure([2, 6, 1])
        ann.set_activation("tanh")
        ann.set_input_data(U)
        ann.set_output_data(Y)
        ann.anneal(alpha=2.0, beta_array=np.arange(12), RM=1.0, RF0=1e-2,
                   clamp_input=True, bounds_W=(-3.0, 3.0),
                   opt_args=dict(maxiter=400), seed=2)
        out[nm] = ann
    ap, aj = out["port"], out["jax"]
    for i in range(12):
        for w in ap.weights_at(i)[0]:
            assert np.all(np.abs(w) <= 3.0)
    Xs = ap.activations_at(-1)
    np.testing.assert_array_equal(Xs[0], U)
    assert ap.minpaths.shape == aj.minpaths.shape == (12, 109)
    for a in (ap, aj):
        assert np.all(np.isfinite(a.A_array))
        assert set(np.unique(a.exitflags)) <= {0, 1, 2}


def test_batched_ensemble_levels():
    """tests/test_nnet_ensemble.py's counterpart: B = 5 members of a
    1-6-1 net through the port's batched ladder (the JAX package vmaps
    its ladder); the level statistics: finite records, the lowest level
    under 0.05 in both packages, and the members at more than one
    level."""
    rng = np.random.default_rng(0)
    M, structure = 16, (1, 6, 1)
    U = np.linspace(-1, 1, M)[:, None]
    Y = np.sin(2.0 * U)
    act_t, parts_t, pack, _ = nnet.nnet_action_factory(
        structure, torch.tanh, lambda z: z, U, Y, 1.0, 1.0, **CPU)
    act_j, parts_j, _, _ = nnet_jax.nnet_action_factory(
        structure, jnp.tanh, lambda z: z, U, Y, 1.0, 1.0)
    xp0s = []
    for _ in range(5):
        W = [0.3 * rng.normal(size=(structure[i + 1], structure[i]))
             for i in range(2)]
        bias = [np.zeros(structure[i + 1]) for i in range(2)]
        X = [U.copy()]
        for l in range(2):
            act = (lambda z: z) if l == 1 else np.tanh
            X.append(act(X[l] @ W[l].T + bias[l]))
        xp0s.append(pack({"X": X, "W": W, "b": bias}))
    xp0s = np.stack(xp0s)
    res = run_ladder(act_t, parts_t, torch.tensor(xp0s), np.arange(10.0),
                     1e-2, 2.0, opts=LBFGSOptions(maxiter=300, pgtol=1e-9),
                     store_paths=False, **CPU)
    A = res.A.numpy()
    assert A.shape == (5, 10) and np.all(np.isfinite(A))
    finals = A[:, -1]
    assert finals.min() < 0.05
    assert np.unique(np.round(finals, 12)).size > 1
    rj = jax.jit(jax.vmap(lambda z: run_ladder_jax(
        act_j, parts_j, z, jnp.arange(10.0), 1e-2, 2.0,
        opts=OptsJax(maxiter=300, pgtol=1e-9), store_paths=False)))(
        jnp.asarray(xp0s))
    assert np.asarray(rj.A)[:, -1].min() < 0.05


# ---- checkpoints across the packages ---------------------------------------

def _ckpt_ann(mod, ctor, U, Y, **kw):
    ann = mod.Annealer(**ctor)
    ann.set_structure([2, 6, 1])
    ann.set_activation("tanh")
    ann.set_input_data(U)
    ann.set_output_data(Y)
    ann.anneal(alpha=2.0, RM=1.0, RF0=1e-2,
               opt_args=dict(maxiter=6, gtol=1e-9), seed=4, **kw)
    return ann


def _as_full(path, betas):
    """Patch a partial run's checkpoint to the full ladder's metadata, as a
    preempted full run would have written it."""
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    payload["n_beta"] = np.asarray(len(betas))
    payload["betas"] = betas
    np.savez(path, **payload)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_checkpoint_across_packages(writer, reader, tmp_path, f64):
    """``writer``'s facade checkpoints rungs 0..3 of 8 (every 2 rungs, the
    flat vector); ``reader``'s facade resumes the file: rungs 0..3 come
    back from it bit for bit, and rungs 4..7 are bit for bit ``reader``'s
    own run from the writer's rung-3 minimizer (W0/b0/X0 from it)."""
    rng = np.random.default_rng(6)
    U = rng.normal(size=(10, 2))
    Y = np.tanh(U[:, :1] - U[:, 1:])
    mods = {"jax": (nnet_jax, {}), "port": (nnet, CPU)}
    betas = np.arange(8)
    p = str(tmp_path / "nn.npz")
    first = _ckpt_ann(*mods[writer], U, Y, beta_array=betas[:4],
                      checkpoint_path=p, checkpoint_every=2)
    _as_full(p, betas.astype(np.float64))
    resumed = _ckpt_ann(*mods[reader], U, Y, beta_array=betas,
                        checkpoint_path=p, checkpoint_every=2)
    for k in ("A_array", "niter_array", "nfev_array", "exitflags"):
        np.testing.assert_array_equal(getattr(resumed, k)[:4],
                                      getattr(first, k))
    np.testing.assert_array_equal(resumed.minpaths[:4], first.minpaths)
    W, b = first.weights_at(-1)
    X = first.activations_at(-1)
    cont = _ckpt_ann(*mods[reader], U, Y, beta_array=betas[4:], W0=W, b0=b,
                     X0=X, checkpoint_path=str(tmp_path / "c.npz"),
                     checkpoint_every=2)
    for k in ("A_array", "me_array", "fe_array", "niter_array",
              "nfev_array", "exitflags"):
        np.testing.assert_array_equal(getattr(resumed, k)[4:],
                                      getattr(cont, k))
    np.testing.assert_array_equal(resumed.minpaths[4:], cont.minpaths)
    with np.load(p) as z:
        assert int(z["next_idx"]) == 8 and str(z["treedef"]) == \
            "PyTreeDef(*)"


def test_surface():
    """va_nnet's alias, the package export, the run checks, and the card:
    Annealer() means the card."""
    assert va_nnet.Annealer is nnet.Annealer is \
        varanneal_tpu_torch.va_nnet.Annealer
    ann = nnet.Annealer(**CPU)
    with pytest.raises(RuntimeError):
        ann.anneal(alpha=2.0, beta_array=[0], RM=1.0, RF0=1e-3)
    ann.set_structure([2, 3, 1])
    ann.set_input_data(np.zeros((4, 3)))
    ann.set_output_data(np.zeros((4, 1)))
    with pytest.raises(ValueError, match="structure"):
        ann.anneal(alpha=2.0, beta_array=[0], RM=1.0, RF0=1e-3)
    ann.set_input_data(np.zeros((4, 2)))
    with pytest.raises(ValueError, match="RF0"):
        ann.anneal(alpha=2.0, beta_array=[0], RM=1.0, RF0=[1e-3] * 3)
    with pytest.raises(RuntimeError):
        ann.save_action_errors("x.dat")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            nnet.Annealer()
