"""K1, K4, K2 and K3 of the port over Lorenz-96's four rules (the
trapezoid rule, Euler, the forward map, Hermite–Simpson) with a scalar or
(N_f-1, D) rf (varanneal_tpu_torch/kernels/ag.py; the kernels are
csrc/ag_rules_kernel.cu and, inside K2/K3, the same walk, whose plain
versions run here on the CPU) against the JAX package; K2's and K3's
solves under the rules are tests/test_torch_solve_rules.py's:

- K1's plain version against the reference's K1 (``make_action_ag``,
  Pallas interpret mode, f32, 2e-5: the two sum in other orders), the XLA
  action in f64 (1e-12) and ``native/valib.cpp`` where it covers the rule
  (the trapezoid rule and Hermite–Simpson at a scalar rf and RM, 1e-12),
  over 4 rules × 2 rf kinds × 2 RM kinds × F estimated or fixed;
- K4's row against ``make_action_ag(compensated=True)``;
- Hermite–Simpson's hand adjoint (dA/dF = -2c h Σ a and the node
  adjoints) against ``torch.autograd`` of the port's plain action;
- an f64 Hermite–Simpson ladder through the facade with ``engine='ag'``
  against the JAX facade (1e-8 at mutually converged rungs, as
  ``tests/test_ladder_integration.py``);
- ``solver='auto'`` keeps m > 8 on the generic loop, as the reference's
  ``solve_supported`` gate does.

Both packages get the identical problem through
``ops.spec.spec_from_reference``; inputs come from numpy seeds."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from varanneal_tpu import native
from varanneal_tpu import api as api_jax
from varanneal_tpu.kernels import ag_pallas, solve_pallas
from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.ops import make_action as make_action_jax
from varanneal_tpu.opt import LBFGSOptions as OptsJax

from varanneal_tpu_torch import api
from varanneal_tpu_torch import support
from varanneal_tpu_torch.kernels import ag, solve
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import make_action, pack, spec_from_reference
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.twin import lorenz96_twin

DISCS = ("trapezoid", "euler", "forwardmap", "SimpsonHermite")


@pytest.fixture(autouse=True)
def _interpret():
    ag_pallas.set_interpret(True)
    solve_pallas.set_interpret(True)
    yield
    ag_pallas.set_interpret(False)
    solve_pallas.set_interpret(False)


def _specs(disc, rm="scalar", est=True, N_data=11, f32_data=False):
    """The twin's problem (D = 20, 8 observed) in both packages.
    ``f32_data``: the data and RM rounded to f32 first, as the Pallas
    solve kernels embed them (tests/test_torch_solve.py)."""
    tw = lorenz96_twin(D=20, N_data=N_data, n_obs=8)
    RM = (tw["RM"] if rm == "scalar" else
          np.random.default_rng(9).uniform(0.5, 2.0, (N_data, 8)))
    if f32_data:
        tw["Y"] = tw["Y"].astype(np.float32).astype(np.float64)
        RM = np.asarray(RM, np.float32).astype(np.float64)
        RM = float(RM) if RM.ndim == 0 else RM
    sj = build_spec_jax(lorenz96_jax, 20, tw["Y"], tw["t"], tw["Lidx"], RM,
                        disc=disc, P=np.array([4.0]),
                        pidx=[0] if est else [])
    st = spec_from_reference(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)},
        lorenz96)
    return tw, sj, st


def _draws(st, tw, B, seed):
    """Data-informed points (tests/test_ag_pallas.py's ``_z0``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        X = rng.normal(2.0, 2.0, (st.N_f, st.D))
        rows = np.arange(st.N_data) * st.obs_stride
        X[np.ix_(rows, np.asarray(st.Lidx))] = tw["Y"] + rng.normal(
            0, 0.3, tw["Y"].shape)
        out.append(pack(st, X, np.array([4.0 + rng.normal()])))
    return np.stack(out)


def _rf(st, kind, seed=4):
    if kind == "scalar":
        return 3.0
    return np.random.default_rng(seed).uniform(0.5, 2.0, (st.N_f - 1, st.D))


def _jax_vag(action, Z, rf):
    return map(np.asarray, jax.vmap(jax.value_and_grad(
        lambda u: action(u, rf)))(jnp.asarray(Z)))


def _close(A, G, A_ref, G_ref, tol):
    np.testing.assert_allclose(np.asarray(A), A_ref, rtol=tol)
    scale = np.abs(G_ref).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(G) / scale, G_ref / scale,
                               rtol=0, atol=tol)


K1_CASES = [(d, rf, rm, est) for d in DISCS for rf in ("scalar", "diag")
            for rm in ("scalar", "diag") for est in (True, False)]


@pytest.mark.parametrize("disc,rf_kind,rm,est", K1_CASES)
def test_plain_k1_matches_jax(disc, rf_kind, rm, est):
    """K1's plain version under each rule and rf kind against the
    reference's K1 (f32, interpret mode, 2e-5), the XLA action (f64,
    1e-12) and the native C++ action where it covers the case (1e-12)."""
    tw, sj, st = _specs(disc, rm, est)
    assert ag.ag_supported(st, _rf(st, rf_kind))
    rf = _rf(st, rf_kind)
    Z = _draws(st, tw, 2, seed=1)
    # f32 against the reference's K1
    act_p, _ = ag_pallas.make_action_ag(sj)
    rf32 = np.asarray(rf, np.float32)
    A_p, G_p = _jax_vag(act_p, Z.astype(np.float32), jnp.asarray(rf32))
    c32 = ag.ag_consts(st, "cpu", torch.float32)
    A, G = ag.ag_reference(torch.tensor(Z, dtype=torch.float32),
                           torch.tensor(rf32) if rf32.ndim else float(rf32),
                           c32)
    _close(A.numpy(), G.numpy(), A_p, G_p, 2e-5)
    # f64 against the XLA action
    A_x, G_x = _jax_vag(make_action_jax(sj)[0], Z, jnp.asarray(rf))
    c64 = ag.ag_consts(st, "cpu", torch.float64)
    A, G = ag.ag_reference(torch.tensor(Z), rf, c64)
    _close(A.numpy(), G.numpy(), A_x, G_x, 1e-12)
    if (disc in ("trapezoid", "SimpsonHermite") and rf_kind == "scalar"
            and rm == "scalar"):
        if not native.available():
            pytest.skip("native C++ oracle does not build here (no g++)")
        fn = (native.l96_trap_action_grad if disc == "trapezoid"
              else native.l96_sh_action_grad)
        for b in range(2):
            a_n, g_n = fn(Z[b], st.N_f, st.D, st.Y, st.Lidx, 1,
                          float(st.RM), rf, st.dt, est_F=est,
                          F_fixed=4.0)
            _close(A[b:b + 1].numpy(), G[b:b + 1].numpy(), np.array([a_n]),
                   g_n[None], 1e-12)


@pytest.mark.parametrize("disc,rf_kind", [(d, k) for d in DISCS
                                          for k in ("scalar", "diag")])
def test_plain_k4_row_matches_jax(disc, rf_kind):
    """K4's plain row, joined by ``ag.combine``, against the reference's
    ``make_action_ag(compensated=True)`` (f32, interpret mode), and its
    planes against the XLA compensated action's pieces: the Simpson plane
    in fe1, the Hermite plane in fe2 (zero under a one-step rule)."""
    tw, sj, st = _specs(disc)
    rf = np.asarray(_rf(st, rf_kind), np.float32)
    Z = _draws(st, tw, 2, seed=2).astype(np.float32)
    act_c, _ = ag_pallas.make_action_ag(sj, compensated=True)
    A_p = np.asarray(jax.vmap(lambda u: act_c(u, jnp.asarray(rf)))(
        jnp.asarray(Z)))
    c = ag.ag_consts(st, "cpu", torch.float32)
    rf_t = torch.tensor(rf) if rf.ndim else float(rf)
    _, _, C = ag.ag_reference(torch.tensor(Z), rf_t, c, compensated=True)
    A = ag.combine(C, rf_t, c)
    np.testing.assert_allclose(A.numpy(), A_p, rtol=2e-6)
    A_v, _ = ag.action_and_grad(torch.tensor(Z), rf_t, c, compensated=True)
    np.testing.assert_array_equal(A_v.numpy(), A.numpy())
    if disc != "SimpsonHermite":
        assert not C[:, 4:].any()
    else:
        assert (C[:, 4] != 0).all()


@pytest.mark.parametrize("rf_kind", ("scalar", "diag"))
def test_sh_adjoint_matches_autograd(rf_kind):
    """Hermite–Simpson's hand adjoint in f64: the node adjoints at even
    and odd rows and dA/dF = -2c h Σ a against torch.autograd of the
    port's plain action (ops.action), to 1e-13 of max|g|."""
    tw, sj, st = _specs("SimpsonHermite", N_data=9)
    rf = _rf(st, rf_kind)
    Z = torch.tensor(_draws(st, tw, 2, seed=5))
    c = ag.ag_consts(st, "cpu", torch.float64)
    A, G = ag.ag_reference(Z, rf, c)
    act, _ = make_action(st, device="cpu")
    z = Z.clone().requires_grad_(True)
    rf_t = rf if np.ndim(rf) == 0 else torch.tensor(rf)
    A_a = act(z, rf_t)
    A_a.sum().backward()
    np.testing.assert_allclose(A.numpy(), A_a.detach().numpy(), rtol=1e-13)
    g_a = z.grad.numpy()
    scale = np.abs(g_a).max()
    X = G[:, : st.n_state].reshape(2, st.N_f, st.D).numpy()
    X_a = g_a[:, : st.n_state].reshape(2, st.N_f, st.D)
    for rows in (slice(0, None, 2), slice(1, None, 2)):
        np.testing.assert_allclose(X[:, rows] / scale, X_a[:, rows] / scale,
                                   rtol=0, atol=1e-13)
    np.testing.assert_allclose(G[:, -1].numpy(), g_a[:, -1], rtol=1e-12)


def test_facade_sh_ladder_engine_ag():
    """An f64 Hermite–Simpson ladder through the port's facade with
    engine='ag' (K1's plain version under the rule) against the JAX
    facade (the XLA action: the reference's K1 takes f32 only): the
    action to 1e-8 of A at the rungs where both converged
    (tests/test_ladder_integration.py's rule), which are most of them."""
    tw = lorenz96_twin(D=20, N_data=11, n_obs=8)
    X0 = tw["traj"] + 0.5 * np.random.default_rng(8).normal(
        size=tw["traj"].shape)
    kw = dict(P0=np.array([6.0]), alpha=1.6, beta_array=np.arange(5),
              RM=tw["RM"], RF0=tw["RM"], Lidx=list(tw["Lidx"]), Pidx=[0],
              opt_args=dict(maxiter=3000, maxcor=5, gtol=1e-8, ftol=0.0),
              dtype=np.float64, disc="SimpsonHermite")
    out = {}
    for nm, mod, f, extra, eng in (
            ("jax", api_jax, lorenz96_jax, {}, "xla"),
            ("port", api, lorenz96, dict(device="cpu"), "ag")):
        ann = mod.Annealer(**extra)
        ann.set_model(f, 20)
        ann.set_data(tw["Y"], t=tw["t"])
        ann.anneal(X0, engine=eng, **kw)
        out[nm] = ann
    aj, ap = out["jax"], out["port"]
    both = (np.asarray(aj.exitflags) == 0) & (ap.exitflags == 0)
    assert both.sum() >= 4, (aj.exitflags, ap.exitflags)
    A_j = np.asarray(aj.A_array)
    np.testing.assert_array_less(np.abs(ap.A_array - A_j)[both],
                                 1e-8 * np.abs(A_j)[both])


def test_solve_preferred_m_gate():
    """``solver='auto'`` on the card takes K2 at m <= 8 and the generic
    loop at m = 9..16, as the reference's ``solve_supported`` gate
    (``solve_pallas.py:216``) keeps its ``solve_preferred``;
    ``solver='fused'`` takes K2 up to MAX_M = 16. The device is pinned to
    the card's policy as ``support._card_policy`` pins it; nothing is
    launched."""
    tw, sj, st = _specs("trapezoid")
    with support._card_policy() as card:
        for m, auto in ((5, True), (8, True), (9, False), (10, False),
                        (16, False)):
            opts = LBFGSOptions(m=m)
            assert solve.solve_preferred(st, 1.0, opts, device=card) == auto
            got = solve.pick_rung_solver(st, 1.0, opts, solver="auto",
                                         device=card)
            assert (got is not None) == auto, m
            assert solve.pick_rung_solver(st, 1.0, opts, solver="fused",
                                          device=card) is not None
            assert (solve_pallas.solve_supported(sj, np.float32(1.0),
                                                 OptsJax(m=m)) == auto)


def test_rule_constants_match_the_sources():
    """The wrappers' rule codes and partial counts are the CUDA sources'
    (WalkDisc, kAgRuleCompSums in csrc/l96_ag_block.cuh), and the rules'
    K4 rings stay on chip up to D = 1,209 in f32 and 603 in f64."""
    import re
    from pathlib import Path
    csrc = Path(ag.__file__).parent / "csrc"
    src = (csrc / "l96_ag_block.cuh").read_text()
    codes = dict(re.findall(r"kWalk(\w+) = (\d)", src))
    assert {k: int(v) for k, v in codes.items()} == {
        "Trapezoid": 0, "Euler": 1, "ForwardMap": 2, "SimpsonHermite": 3}
    assert [ag.DISCS[d] for d in DISCS] == [0, 1, 2, 3]
    assert int(re.search(r"constexpr int kAgRuleCompSums = (\d+);",
                         src)[1]) == ag.AG_RULE_COMP_SUMS
    for dt, edge in ((torch.float32, 1209), (torch.float64, 603)):
        assert ag.ring_on_chip(edge, dt, compensated=True, rules=True)
        assert not ag.ring_on_chip(edge + 1, dt, compensated=True,
                                   rules=True)
    for name in ("solve_rules_f32.cu", "solve_rules_f64.cu"):
        assert "va_l96_solve_rule_" + name[12:15] in (csrc / name).read_text()
