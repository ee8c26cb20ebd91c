"""K6's value and gradient without autograd's graph (kernels/fe.py), on
the CPU, in f64, held against the JAX package with inputs from numpy
seeds:

- ``sh_vag_reference``, the plain version of the fused Hermite–Simpson
  launch, through ``fe_value_and_grad`` against the JAX package's
  ``make_fe_pallas`` in interpret mode and its ``jax.grad``, member by
  member (Lorenz-96 and NaKL with the stimulus, B=2), its value partials
  against the plain forward's; one member's value and gradient at B=1
  and inside B=64, which the grid rule cuts into other blocks;
- ``make_action_pallas(...).value_and_grad`` against the JAX package's
  ``make_action_pallas`` in interpret mode and its ``jax.grad`` (the XLA
  action for the log-space NaKL model, which the JAX package's Pallas K6
  cannot trace), at 1e-12: Hermite–Simpson and the trapezoid rule,
  Lorenz-96 (scalar, (N_data, L) and (N_data, L, L) RM) and NaKL, plain
  and log-space, with and without estimated parameters; the ladders'
  ``ops.action.value_and_grad`` takes it, and it equals the gradient
  through autograd's graph;
- the Hermite–Simpson grid rule (``rows_per_block``, ``sh_threads``,
  ``FeConsts.rows``): at BASELINE config #3's shape no thread takes two
  intervals, and a smaller ``block_n`` caps a block's intervals;
- ``onestep_vag_reference``, the plain version of the fused one-step
  launch, through ``fe_value_and_grad`` against the JAX package's
  ``make_fe_pallas`` in interpret mode and its ``jax.grad`` (the three
  one-step rules × scalar and (N_f-1, D) rf, Lorenz-96 and NaKL with the
  stimulus, B=2), its value partials bit for bit the plain forward's;
  one member alone and inside B=64; the one-step grid rule at BASELINE
  configs #1 and #3.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu import models as models_jax
from varanneal_tpu import twin as twin_jax
from varanneal_tpu.kernels import fe_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax

from varanneal_tpu_torch import models
from varanneal_tpu_torch.kernels import fe
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import value_and_grad
from varanneal_tpu_torch.ops.spec import spec_from_reference

CPU = torch.device("cpu")
LOG_IDX = models.NAKL_TAU_IDX + models.NAKL_G_IDX


@pytest.fixture(autouse=True)
def _interpret_mode():
    fe_pallas.set_interpret(True)
    yield
    fe_pallas.set_interpret(False)


def _l96(disc, pidx=(0,), rm="scalar", N_data=23, D=6):
    """tests/test_pallas.py's Lorenz-96 problem, in both packages, with a
    scalar, (N_data, L) or (N_data, L, L) RM."""
    rng = np.random.default_rng(0)
    t = 0.025 * np.arange(N_data)
    Y = rng.normal(size=(N_data, 3))
    if rm == "scalar":
        RM = 4.0
    elif rm == "diag":
        RM = rng.uniform(1.0, 4.0, (N_data, 3))
    else:
        a = rng.normal(size=(N_data, 3, 3))
        RM = np.einsum("nij,nkj->nik", a, a) + np.eye(3)
    sj = build_spec_jax(lorenz96_jax, D, Y, t, [0, 2, 4], RM, disc=disc,
                        P=np.array([8.17]), pidx=list(pidx))
    return sj, spec_from_reference(dataclasses.asdict(sj), lorenz96)


def _nakl(disc, pidx=(1, 2, 3, 4, 5), log=False, N=18):
    """tests/test_torch_nakl.py's NaKL problem (the stimulus on), in both
    packages; the log model over LOG_IDX where ``log``."""
    tw = twin_jax.nakl_twin(N=N, dt=0.04, sigma=1.0, seed=7, seg=8)
    if log:
        fj, P = models_jax.nakl_log_model(LOG_IDX)
        ft = models.nakl_log_model(LOG_IDX)[0]
    else:
        fj, ft = models_jax.nakl, models.nakl
        P = np.asarray(models.NAKL_P_TRUE)
    sj = build_spec_jax(fj, 4, tw["V"], tw["t"], [0], 1.0, disc=disc, P=P,
                        pidx=list(pidx), stim=tw["stim"])
    return sj, spec_from_reference(dataclasses.asdict(sj), ft)


def _decision(st, B, seed):
    """B decision vectors near a plausible path: Lorenz-96 states N(0, 2),
    NaKL's V around -60 with gates in (0.05, 0.95); the estimated
    parameters 5 % off their base values."""
    rng = np.random.default_rng(seed)
    if st.D == 4:
        X = np.concatenate([rng.uniform(-75, -45, (B, st.N_f, 1)),
                            rng.uniform(0.05, 0.95, (B, st.N_f, 3))], -1)
    else:
        X = rng.normal(0.0, 2.0, (B, st.N_f, st.D))
    pb = np.asarray(st.P_base)[list(st.pidx)]
    pest = pb + 0.05 * np.abs(pb) * rng.normal(size=(B, len(st.pidx)))
    return np.concatenate([X.reshape(B, -1), pest], axis=-1)


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("model", ["l96", "nakl"])
def test_sh_vag_reference_matches_jax(model):
    """The fused launch's plain version (value partials, triplet and
    parameter partials on shared blocks), scaled and joined by
    fe_value_and_grad, against JAX's make_fe_pallas and jax.grad member by
    member (B=2, an (N_f-1, D) rf, block_n=8: several blocks); its value
    partials bit for bit the plain forward's."""
    sj, st = _l96("SimpsonHermite") if model == "l96" else _nakl(
        "SimpsonHermite")
    Z = _decision(st, 2, 3)
    X = Z[:, : st.n_state].reshape(2, st.N_f, st.D)
    pest = Z[:, st.n_state:]
    rf = np.random.default_rng(4).uniform(0.5, 2.0, (st.N_f - 1, st.D))
    rf = rf * (2e-3 if model == "nakl" else 1.0)
    c = fe.fe_consts(st, torch.float64, CPU, block_n=8)
    Xt, pt, rft = torch.tensor(X), torch.tensor(pest), torch.tensor(rf)
    assert c.n_blocks(2) > 1
    out = fe.sh_vag_reference(Xt, pt, rft, c)
    assert torch.equal(out[0], fe.sh_fwd_reference(Xt, pt, rft, c))
    assert out[0].shape == (2, c.n_blocks(2))
    assert out[4].shape == (2, c.NP, c.n_blocks(2))
    v, gX, gp = fe.fe_value_and_grad(Xt, pt, rft, c)
    fj = fe_pallas.make_fe_pallas(sj, block_n=8)
    vg_j = jax.jit(jax.value_and_grad(
        lambda x, p: fj(x, p, jnp.asarray(rf)), argnums=(0, 1)))
    for b in range(2):
        v_j, g_j = vg_j(jnp.asarray(X[b]), jnp.asarray(pest[b]))
        _close(float(v[b]), float(v_j))
        _close(gX[b].numpy(), g_j[0])
        _close(gp[b].numpy(), g_j[1])


@pytest.mark.parametrize("model", ["l96", "nakl"])
def test_sh_member_across_batch(model):
    """One member's value and gradient alone (B=1) and as member 5 of
    B=64, which the grid rule cuts into other blocks (Lorenz-96 at the
    card's default SM count; NaKL at N_f=81 with one SM, where 64 members
    take one block a member and one member two): the gradient rows bit for
    bit (no sum crosses a block), the value and the parameter gradient
    (sums over blocks, in another order) within 1e-14 relative."""
    if model == "l96":
        _, st = _l96("SimpsonHermite")
        n_sm = fe.DEFAULT_SMS
    else:
        _, st = _nakl("SimpsonHermite", N=41)
        n_sm = 1
    c = dataclasses.replace(fe.fe_consts(st, torch.float64, CPU),
                            n_sm=n_sm)
    assert c.n_blocks(1) != c.n_blocks(64)
    Z = _decision(st, 64, 6)
    X = torch.tensor(Z[:, : st.n_state].reshape(64, st.N_f, st.D))
    pest = torch.tensor(Z[:, st.n_state:])
    v64, g64, p64 = fe.fe_value_and_grad(X, pest, 2e-3, c)
    v1, g1, p1 = fe.fe_value_and_grad(X[5:6], pest[5:6], 2e-3, c)
    assert torch.equal(g1[0], g64[5])
    _close(float(v1[0]), float(v64[5]), rtol=1e-14)
    _close(p1[0].numpy(), p64[5].numpy(), rtol=1e-14)


@pytest.mark.parametrize("model,disc,pidx,rm", [
    ("l96", "SimpsonHermite", (0,), "scalar"),
    ("l96", "SimpsonHermite", (), "diag"),
    ("l96", "trapezoid", (0,), "full"),
    ("nakl", "SimpsonHermite", (1, 2, 3, 4, 5), "scalar"),
    ("nakl", "SimpsonHermite", (), "scalar"),
    ("nakl", "trapezoid", (1, 2, 3, 4, 5), "scalar"),
    ("nakl_log", "SimpsonHermite", tuple(range(1, 19)), "scalar")])
def test_action_value_and_grad_matches_jax(model, disc, pidx, rm):
    """make_action_pallas's value_and_grad (ME's gradient in closed form,
    FE's from the fused plain version or the one-step pair, no graph)
    against JAX's make_action_pallas in interpret mode (its XLA action for
    the log model) and jax.grad, member by member, f64 1e-12; the same
    function serves ops.action.value_and_grad, and it equals the gradient
    through autograd's graph of the same action."""
    if model == "l96":
        sj, st = _l96(disc, pidx, rm, N_data=23 if disc != "trapezoid"
                      else 29)
    else:
        sj, st = _nakl(disc, pidx, log=model == "nakl_log")
    XP = _decision(st, 2, 5)
    rf = 2e-3 if model != "l96" else 3e-3
    act, _ = fe.make_action_pallas(st, block_n=8, device=CPU)
    vag = value_and_grad(act)
    assert vag is act.value_and_grad
    A, G = vag(torch.tensor(XP), rf)
    act_j = (make_action_jax(sj)[0] if model == "nakl_log"
             else fe_pallas.make_action_pallas(sj, block_n=8)[0])
    vg_j = jax.jit(jax.value_and_grad(lambda x: act_j(x, rf)))
    for b in range(2):
        a_j, g_j = vg_j(jnp.asarray(XP[b]))
        _close(float(A[b]), float(a_j))
        _close(G[b].numpy(), g_j)
    x = torch.tensor(XP, requires_grad=True)
    (g_graph,) = torch.autograd.grad(act(x, rf).sum(), x)
    _close(G.numpy(), g_graph.numpy())


def test_sh_grid_rule():
    """Hermite–Simpson's intervals a block: at config #3's shape (M =
    3,000, D = 4; B = 1, 4 and 64) a block's intervals are no more than
    its threads, so no thread takes two, and one member spreads over more
    blocks than the per-pair design's 47 at block_n 64; a smaller block_n
    caps the intervals a block; Lorenz-96 at config #2's width (D = 100)
    takes at most 256 // D intervals and one thread a pair; FeConsts.rows
    follows the batch, not the dtype; the forward, the backward and the
    fused launch share one partition."""
    for B in (1, 4, 64):
        for block_n in (512, 64, 16):
            bk = fe.rows_per_block("sh_vag", 3000, 4, block_n, "nakl", B)
            assert bk == fe.rows_per_block("sh_fwd", 3000, 4, block_n,
                                           "nakl", B)
            assert 1 <= bk <= min(block_n, fe.sh_threads("nakl", bk, 4))
    assert fe.rows_per_block("sh_vag", 3000, 4, 64, "nakl", 1) == 32
    assert -(-3000 // fe.rows_per_block("sh_vag", 3000, 4, 512, "nakl",
                                         1)) == 94
    assert fe.rows_per_block("sh_vag", 3000, 4, 512, "nakl", 64) == 256
    for B, want in ((1, 1), (8, 2)):
        bk = fe.rows_per_block("sh_vag", 120, 100, 64, "l96", B)
        assert bk == want and bk * 100 <= fe.sh_threads("l96", bk, 100)
    assert fe.sh_threads("l96", 1, 1000) == 1024
    _, st = _nakl("SimpsonHermite")
    c = fe.fe_consts(st, torch.float64, CPU, block_n=512)
    assert (c.rows(1), c.rows(3)) == (17, 17)
    c32 = fe.fe_consts(st, torch.float32, CPU, block_n=512)
    assert [c32.rows(B) for B in (1, 3, 64)] == [c.rows(B)
                                                  for B in (1, 3, 64)]
    c8 = dataclasses.replace(fe.fe_consts(st, torch.float64, CPU,
                                          block_n=8), n_sm=1)
    assert (c8.rows(2), c8.n_blocks(2)) == (8, 3)


@pytest.mark.parametrize("rf_kind", ["scalar", "diag"])
@pytest.mark.parametrize("disc", ["trapezoid", "euler", "forwardmap"])
@pytest.mark.parametrize("model", ["l96", "nakl"])
def test_onestep_vag_reference_matches_jax(model, disc, rf_kind):
    """The fused one-step launch's plain version (value partials, gradient
    rows and parameter partials on shared blocks), scaled by
    fe_value_and_grad, against JAX's make_fe_pallas (its _kern_scalar or
    _kern_diag and _kern_bwd, interpret mode) and jax.grad member by
    member (B=2, block_n=8: several blocks), f64 1e-12; its value
    partials bit for bit the plain forward's."""
    sj, st = _l96(disc) if model == "l96" else _nakl(disc)
    Z = _decision(st, 2, 3)
    X = Z[:, : st.n_state].reshape(2, st.N_f, st.D)
    pest = Z[:, st.n_state:]
    scale = 2e-3 if model == "nakl" else 3e-3
    rf = scale if rf_kind == "scalar" else scale * np.random.default_rng(
        4).uniform(0.5, 2.0, (st.N_f - 1, st.D))
    c = fe.fe_consts(st, torch.float64, CPU, block_n=8)
    Xt, pt = torch.tensor(X), torch.tensor(pest)
    rft = rf if rf_kind == "scalar" else torch.tensor(rf)
    assert c.n_blocks(2) > 1
    out = fe.onestep_vag_reference(Xt, pt, rft, c)
    assert torch.equal(out[0], fe.onestep_fwd_reference(Xt, pt, rft, c))
    assert out[0].shape == (2, c.n_blocks(2))
    assert out[1].shape == (2, st.N_f, st.D)
    assert out[2].shape == (2, c.NP, c.n_blocks(2))
    v, gX, gp = fe.fe_value_and_grad(Xt, pt, rft, c)
    fj = fe_pallas.make_fe_pallas(sj, block_n=8)
    vg_j = jax.jit(jax.value_and_grad(
        lambda x, p: fj(x, p, jnp.asarray(rf)), argnums=(0, 1)))
    for b in range(2):
        v_j, g_j = vg_j(jnp.asarray(X[b]), jnp.asarray(pest[b]))
        _close(float(v[b]), float(v_j))
        _close(gX[b].numpy(), g_j[0])
        _close(gp[b].numpy(), g_j[1])


@pytest.mark.parametrize("model", ["l96", "nakl"])
def test_onestep_member_across_batch(model):
    """One member's one-step value and gradient alone (B=1) and as member
    5 of B=64, which the grid rule cuts into other blocks (Lorenz-96 at
    the card's default SM count: one row a block at B=1, six at B=64; NaKL
    at N_f=41 with one SM: 30 rows a block, then 41): the gradient rows bit
    for bit (no sum crosses a block), the value and the parameter gradient
    (sums over blocks, in another order) within 1e-14 relative."""
    if model == "l96":
        _, st = _l96("trapezoid")
        n_sm = fe.DEFAULT_SMS
    else:
        _, st = _nakl("trapezoid", N=41)
        n_sm = 1
    c = dataclasses.replace(fe.fe_consts(st, torch.float64, CPU),
                            n_sm=n_sm)
    assert c.n_blocks(1) != c.n_blocks(64)
    Z = _decision(st, 64, 6)
    X = torch.tensor(Z[:, : st.n_state].reshape(64, st.N_f, st.D))
    pest = torch.tensor(Z[:, st.n_state:])
    v64, g64, p64 = fe.fe_value_and_grad(X, pest, 2e-3, c)
    v1, g1, p1 = fe.fe_value_and_grad(X[5:6], pest[5:6], 2e-3, c)
    assert torch.equal(g1[0], g64[5])
    _close(float(v1[0]), float(v64[5]), rtol=1e-14)
    _close(p1[0].numpy(), p64[5].numpy(), rtol=1e-14)


def test_onestep_grid_rule():
    """The one-step rows a block and threads, one partition for the
    value-only and the fused launch: at config #1's shape (Lorenz-96
    N_f=161, D=20) one row a block at B=1 (161 blocks of 64 threads, one
    (row, component) pair a thread) and three at B=4 (54 blocks a member);
    at config #3's one-step shape (NaKL N_f=3,001) a warp of 30 rows at
    B=1 (101 blocks), two at B=4 under select_action's block_n 64, eight
    warps (240 rows) at B=64; a smaller block_n caps the rows."""
    f32 = torch.float32
    for B, bn, nb, thr in ((1, 1, 161, 64), (4, 3, 54, 96)):
        for kern in ("onestep_fwd", "onestep_vag"):
            assert fe.rows_per_block(kern, 161, 20, 64, "l96", B) == bn
        assert -(-161 // bn) == nb
        assert fe.onestep_threads("l96", bn, 20) == thr
        assert (bn + 1) * 20 <= thr
    for B, block_n, bn, thr in ((1, 64, 30, 32), (4, 64, 60, 64),
                                (64, 512, 240, 256), (64, 8, 8, 32)):
        assert fe.rows_per_block("onestep_vag", 3001, 4, block_n, "nakl",
                                 B) == bn
        assert fe.onestep_threads("nakl", bn, 4) == thr
    _, st = _l96("trapezoid", N_data=161, D=20)
    c = fe.fe_consts(st, f32, CPU, block_n=64)
    assert (c.rows(1), c.n_blocks(1)) == (1, 161)
    assert (c.rows(4), c.n_blocks(4)) == (3, 54)
