"""The compact-form direction (K7a) and the fused step (K7b) of the port
(varanneal_tpu_torch/kernels/dir.py, whose plain versions run on the
CPU) against the JAX package's Pallas kernels
(varanneal_tpu/kernels/dir_pallas.py, in interpret mode, as
tests/test_dir_pallas.py runs them), at every (head, hlen) of an m=5
history and at m=7, under that test's bounds: direction rtol 2e-5 / atol
2e-6; history rows and max|g| rtol 1e-6; Σ|g| rtol 1e-5; good, head and
hlen exact. The plain f32 step's own error against f64 at the card
tests' shape, which caps the card's direction bound. Then the port's
fused loop (opt/lbfgs.py, direction='compact_pallas') against the JAX
solver's, and the direction resolution."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu.kernels import dir_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax
from varanneal_tpu.opt import lbfgs_minimize as lbfgs_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax

from varanneal_tpu_torch.kernels import dir as kdir
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, make_action, value_and_grad
from varanneal_tpu_torch.opt import LBFGSOptions, lbfgs_minimize
from varanneal_tpu_torch.opt.lbfgs import _resolve_direction
from tests.test_ladder_integration import make_twin


@pytest.fixture(autouse=True)
def _interpret():
    dir_pallas.set_interpret(True)
    yield
    dir_pallas.set_interpret(False)


def _history(rng, m, head, hlen, n):
    """A (2m, n) f32 history with hlen valid pairs ending before head."""
    H = np.zeros((2 * m, n), np.float32)
    for j in range(hlen):
        slot = (head - hlen + j) % m
        s = rng.normal(size=n)
        H[slot], H[m + slot] = s, rng.normal(size=n) * 0.3 + s
    return H


def _cases(m, heads, n, seed):
    rng = np.random.default_rng(seed)
    pairs = [(h, l) for h in heads for l in range(m + 1)]
    H = np.stack([_history(rng, m, h, l, n) for h, l in pairs])
    g = rng.normal(size=(len(pairs), n)).astype(np.float32)
    return pairs, H, g


@pytest.mark.parametrize("m,heads", [(5, [0]), (5, [1]), (5, [2]), (5, [3]),
                                     (5, [4]), (7, [0, 3, 6])])
def test_compact_dir_matches_jax(m, heads):
    """K7a's plain version against compact_dir_pallas at every hlen of the
    given heads, all members in one batch."""
    pairs, H, g = _cases(m, heads, 37 + 10 * m, seed=m * 10 + heads[0])
    hd = np.array([p[0] for p in pairs], np.int32)
    hl = np.array([p[1] for p in pairs], np.int32)
    d_j = np.asarray(jax.vmap(dir_pallas.compact_dir_pallas)(
        jnp.asarray(g), jnp.asarray(H), jnp.asarray(hd), jnp.asarray(hl)))
    d_p = kdir.compact_dir(torch.tensor(g), torch.tensor(H),
                           torch.tensor(hd), torch.tensor(hl))
    np.testing.assert_allclose(d_p.numpy(), d_j, rtol=2e-5, atol=2e-6)


def _step_inputs(rng, B, n, flat=()):
    x_old = rng.normal(size=(B, n)).astype(np.float32)
    g_old = rng.normal(size=(B, n)).astype(np.float32)
    x_new = (x_old + 0.1 * rng.normal(size=(B, n))).astype(np.float32)
    g_new = (g_old + 0.1 * rng.normal(size=(B, n))).astype(np.float32)
    for b in flat:          # sᵀy ~ 0: the curvature gate must refuse
        x_new[b] = x_old[b] + 1e-12
        g_new[b] = g_old[b]
    return x_old, x_new, g_old, g_new


@pytest.mark.parametrize("m,heads", [(5, [0]), (5, [1]), (5, [2]), (5, [3]),
                                     (5, [4]), (7, [0, 5])])
def test_fused_step_matches_jax(m, heads):
    """K7b's plain version against dir_pallas.fused_step at every hlen of
    the given heads, with one member's line search failed and one step
    flat (both refused by the gate)."""
    n = 300
    pairs, H, _ = _cases(m, heads, n, seed=100 + m * 10 + heads[0])
    B = len(pairs)
    rng = np.random.default_rng(7 + heads[0])
    x_old, x_new, g_old, g_new = _step_inputs(rng, B, n, flat=(1,))
    hd = np.array([p[0] for p in pairs], np.int32)
    hl = np.array([p[1] for p in pairs], np.int32)
    ls_ok = np.ones(B, bool)
    ls_ok[2] = False
    rows, n_pad = 16, 384
    A = np.zeros((B, rows, n_pad), np.float32)
    A[:, : 2 * m, :n] = H
    A[:, 2 * m, :n] = g_old
    A2, d_j, good_j, pgn_j, g1_j, head_j, hlen_j = jax.vmap(
        lambda *a: dir_pallas.fused_step(m, *a))(
        jnp.asarray(A), jnp.asarray(x_old), jnp.asarray(x_new),
        jnp.asarray(g_old), jnp.asarray(g_new), jnp.asarray(hd),
        jnp.asarray(hl), jnp.asarray(ls_ok))
    Ht = torch.tensor(H)
    head_t, hlen_t = torch.tensor(hd), torch.tensor(hl)
    d_p, sc = kdir.fused_step(Ht, *map(torch.tensor, (x_old, x_new, g_old,
                                                       g_new)),
                              head_t, hlen_t, torch.tensor(ls_ok),
                              torch.ones(B, dtype=torch.bool))
    good, pgn, g1, h2, l2 = (sc[:, i].numpy() for i in range(5))
    np.testing.assert_array_equal(good > 0.5, np.asarray(good_j))
    assert not good[1] and not good[2]
    np.testing.assert_array_equal(head_t.numpy(), np.asarray(head_j))
    np.testing.assert_array_equal(hlen_t.numpy(), np.asarray(hlen_j))
    np.testing.assert_array_equal(h2, np.asarray(head_j))
    np.testing.assert_array_equal(l2, np.asarray(hlen_j))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(A2)[:, : 2 * m, :n],
                               rtol=1e-6)
    np.testing.assert_allclose(pgn, np.asarray(pgn_j), rtol=1e-6)
    np.testing.assert_allclose(g1, np.asarray(g1_j), rtol=1e-5)
    d_j = np.asarray(d_j)
    np.testing.assert_allclose(d_p.numpy(), d_j, rtol=2e-5, atol=2e-6)
    # the scalar row's sᵀy and g_newᵀd
    sv, yv = x_new - x_old, g_new - g_old
    np.testing.assert_allclose(sc[:, 5].numpy(),
                               np.einsum("bn,bn->b", sv, yv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sc[:, 6].numpy(),
                               np.einsum("bn,bn->b", g_new, d_j), rtol=1e-4)


def test_fused_step_leaves_ended_members():
    """A member whose loop has ended keeps its history, head and hlen bit
    for bit and gets d = 0; the others step as in a batch of their own."""
    m, n, B = 5, 50, 3
    rng = np.random.default_rng(5)
    H = np.stack([_history(rng, m, 2, 3, n) for _ in range(B)])
    vecs = _step_inputs(rng, B, n)
    run = torch.tensor([True, False, True])
    Ht, hd, hl = torch.tensor(H), torch.full((B,), 2, dtype=torch.int32), \
        torch.full((B,), 3, dtype=torch.int32)
    d, sc = kdir.fused_step(Ht, *map(torch.tensor, vecs), hd, hl,
                            torch.ones(B, dtype=torch.bool), run)
    assert torch.equal(Ht[1], torch.tensor(H[1]))
    assert (int(hd[1]), int(hl[1])) == (2, 3)
    assert torch.equal(d[1], torch.zeros(n))
    assert sc[1].tolist() == [0.0, 0.0, 0.0, 2.0, 3.0, 0.0, 0.0]
    assert (int(hd[0]), int(hl[0])) == (3, 4)
    H2 = torch.tensor(H[[0, 2]])
    h2 = torch.full((2,), 2, dtype=torch.int32)
    l2 = torch.full((2,), 3, dtype=torch.int32)
    d2, sc2 = kdir.fused_step(H2, *(torch.tensor(v[[0, 2]]) for v in vecs),
                              h2, l2, torch.ones(2, dtype=torch.bool),
                              torch.ones(2, dtype=torch.bool))
    assert torch.equal(d[[0, 2]], d2) and torch.equal(sc[[0, 2]], sc2)
    assert torch.equal(Ht[[0, 2]], H2)


def test_plain_step_f32_error_at_card_shape():
    """The plain f32 step's own direction error against f64 at the card
    tests' shape (n = 3,221, m = 7, four members, random (head, hlen)),
    over 40 seeded batches: at most 3.6e-5 of max|d| (3.50e-5 here). The
    card's direction bound takes twice this error as its witness, so
    capping the witness at 7.2e-5 rests on this reading."""
    m, n, B = 7, 3221, 4
    worst = 0.0
    for seed in range(40):
        rng = np.random.default_rng(1000 * m + seed)
        pairs = [(int(rng.integers(m)), int(rng.integers(m + 1)))
                 for _ in range(B)]
        H = np.stack([_history(rng, m, h, l, n) for h, l in pairs])
        g_old, x_old = (rng.normal(size=(B, n)).astype(np.float32)
                        for _ in range(2))
        x_new = (x_old + 0.1 * rng.normal(size=(B, n))).astype(np.float32)
        g_new = (g_old + 0.1 * rng.normal(size=(B, n))).astype(np.float32)
        vecs = (x_old, x_new, g_old, g_new)
        hd = torch.tensor([p[0] for p in pairs], dtype=torch.int32)
        hl = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
        ok = torch.ones(B, dtype=torch.bool)
        d32, _ = kdir.fused_step_reference(
            torch.tensor(H), *map(torch.tensor, vecs), hd.clone(),
            hl.clone(), ok, ok)
        d64, _ = kdir.fused_step_reference(
            torch.tensor(H, dtype=torch.float64),
            *(torch.tensor(v, dtype=torch.float64) for v in vecs),
            hd.clone(), hl.clone(), ok, ok)
        err = torch.amax(torch.abs(d32.double() - d64), dim=1) / torch.amax(
            torch.abs(d64), dim=1)
        worst = max(worst, float(err.max()))
    assert worst <= 3.6e-5


def _rosen_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen_vag_torch(x):
    with torch.enable_grad():
        z = x.detach().requires_grad_(True)
        f = torch.sum(100.0 * (z[:, 1:] - z[:, :-1] ** 2) ** 2
                      + (1.0 - z[:, :-1]) ** 2, dim=-1)
        (g,) = torch.autograd.grad(f.sum(), z)
    return f.detach(), g


def _jax_batched(vag, X0, opts):
    r = jax.jit(jax.vmap(lambda x0: lbfgs_jax(vag, x0, opts=opts)))(
        jnp.asarray(X0))
    return {k: np.asarray(getattr(r, k))
            for k in ("x", "f", "niter", "nfev", "status", "pgnorm")}


def _assert_counts_f(rt, rj, ftol):
    np.testing.assert_array_equal(rt.niter.numpy(), rj["niter"])
    np.testing.assert_array_equal(rt.nfev.numpy(), rj["nfev"])
    np.testing.assert_array_equal(rt.status.numpy(), rj["status"])
    np.testing.assert_allclose(rt.f.numpy(), rj["f"], rtol=ftol)


def test_fused_loop_rosenbrock_matches_jax():
    """f32 Rosenbrock, 4 members, the first 15 iterations through the fused
    loop of both packages: identical counts, f to 1e-4 relative. Longer
    f32 solves part under rounding alone: at 25 iterations the JAX
    solver's own 'compact' and 'compact_pallas' directions give f 1.5e-3
    apart, and full solves end an iteration apart."""
    X0 = np.random.default_rng(0).uniform(-1.5, 1.5, (4, 6)).astype(
        np.float32)
    kw = dict(m=5, maxiter=15, pgtol=1e-5, ftol=0.0,
              direction="compact_pallas")
    rj = _jax_batched(jax.value_and_grad(_rosen_jax), X0, OptsJax(**kw))
    rt = lbfgs_minimize(_rosen_vag_torch, torch.tensor(X0),
                        opts=LBFGSOptions(**kw), device="cpu")
    _assert_counts_f(rt, rj, 1e-4)
    np.testing.assert_allclose(rt.pgnorm.numpy(), rj["pgnorm"], rtol=1e-3)
    assert (rt.status.numpy() == 2).all()


def test_fused_loop_l96_matches_jax():
    """A short f32 Lorenz-96 solve (3 members, 30 iterations), each package
    with its own f32 action, through both fused loops: identical counts,
    f to 1e-4 relative."""
    D, N_data, Lidx = 5, 21, (0, 1, 3)
    traj, Y, t, rng = make_twin(D=D, N_data=N_data, Lidx=Lidx)
    kw_s = dict(disc="trapezoid", P=np.array([4.0]), pidx=[0])
    spec_j = build_spec_jax(lorenz96_jax, D, Y, t, Lidx, 6.25, **kw_s)
    spec_t = build_spec(lorenz96, D, Y, t, Lidx, 6.25, **kw_s)
    X0 = np.empty((3, spec_t.n_dof), np.float32)
    X0[:, :-1] = (traj[None] + 0.3 * rng.normal(size=(3,) + traj.shape)
                  ).reshape(3, -1)
    X0[:, -1] = 8.17 + 0.5 * rng.normal(size=3)
    rf = np.float32(10.0)
    kw = dict(m=5, maxiter=30, pgtol=1e-4, ftol=1e-6,
              direction="compact_pallas")
    act_j, _ = make_action_jax(spec_j)
    rj = _jax_batched(jax.value_and_grad(lambda z: act_j(z, rf)), X0,
                      OptsJax(**kw))
    vag = value_and_grad(make_action(spec_t, device="cpu")[0])
    rt = lbfgs_minimize(lambda z: vag(z, float(rf)), torch.tensor(X0),
                        opts=LBFGSOptions(**kw), device="cpu")
    _assert_counts_f(rt, rj, 1e-4)
    assert rt.x.dtype == torch.float32 and (rt.niter.numpy() > 5).all()


def test_direction_resolution():
    """'auto' takes the kernels only on the card (f32, 2m + 1 <= 16 rows,
    n <= 32k); an explicit 'compact_pallas' runs the plain versions on CPU
    tensors inside that envelope and 'compact' outside it."""
    x32 = torch.zeros(2, 10)
    x64 = x32.double()
    big = torch.zeros(1, 32 * 1024 + 1)
    for direction, x, m, want in (
            ("auto", x32, 5, "compact"), ("auto", x64, 5, "compact"),
            ("compact_pallas", x32, 5, "compact_pallas"),
            ("compact_pallas", x32, 7, "compact_pallas"),
            ("compact_pallas", x32, 8, "compact"),
            ("compact_pallas", x64, 5, "compact"),
            ("compact_pallas", big, 5, "compact"),
            ("two_loop", x32, 5, "two_loop")):
        opts = LBFGSOptions(m=m, direction=direction)
        assert _resolve_direction(opts, x) == want, (direction, m)
    assert not kdir.dir_supported(x32, 5)
    with pytest.raises(ValueError):
        _resolve_direction(LBFGSOptions(direction="qr"), x32)
    with pytest.raises(ValueError):        # the kernel takes CUDA tensors
        kdir.compact_dir_kernel(x32, torch.zeros(2, 10, 10),
                                torch.zeros(2, dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32))


# (n, B) -> blocks a member of K7b at m = 5 on a card of 132 SMs: one
# block for every 512 columns, at most 8, at most the SMs over B (one
# block a member at B = 1024), at least as many as keep a slice's rows
# in a block's shared memory (8 at n = 32,768)
_CLUSTER_SIZE = {(1, 1): 1, (1, 4): 1, (1, 1024): 1,
                 (37, 1): 1, (37, 4): 1, (37, 1024): 1,
                 (3221, 1): 7, (3221, 4): 7, (3221, 1024): 1,
                 (32768, 1): 8, (32768, 4): 8, (32768, 1024): 8}


@pytest.mark.parametrize("n", [1, 37, 3221, 32768])
@pytest.mark.parametrize("B", [1, 4, 1024])
def test_cluster_plan(n, B):
    """K7's launch plan (kernels/dir.py::cluster_plan), a pure function:
    the cluster's blocks cover the n columns with none empty, within the
    portable 8; a block's shared memory is its fixed area and the rows it
    keeps, within 227 KB; at m <= 5 every row of a slice stays on chip
    (the history, s, y and g read once), at m = 6 and 7 the history's
    rows do up to n = 32,528 (m = 7 at n = 32,768: one row read again);
    at the main shape (n = 3,221, B = 4) 7 blocks of 461 columns."""
    assert kdir.cluster_plan(n, 5, B).size == _CLUSTER_SIZE[(n, B)]
    for m in range(1, 8):
        for step in (False, True):
            p = kdir.cluster_plan(n, m, B, step)
            assert 1 <= p.size <= kdir.MAX_CLUSTER
            assert p.width == -(-n // p.size)
            assert (p.size - 1) * p.width < n <= p.size * p.width
            assert p.smem_bytes == (kdir.fixed_bytes(m, step)
                                    + 4 * p.rows * p.width)
            assert p.smem_bytes <= kdir.SMEM_LIMIT
            rows = kdir.slice_rows(m, step)
            if m <= 5:
                assert p.rows == rows
            elif m == 6 or n < 32768:
                assert p.rows >= 2 * m
            else:
                assert p.size == 8 and p.rows == 13
            if n <= 512 or B >= 133:        # one block a member fits
                assert p.size == 1 or n == 32768
    if (n, B) == (3221, 4):
        assert kdir.cluster_plan(n, 5, B) == kdir.ClusterPlan(
            7, 461, 13, kdir.fixed_bytes(5, True) + 4 * 13 * 461)
