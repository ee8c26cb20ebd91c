"""K6 on Lorenz-96 and the facade over K6 on NaKL, this checkout against
another checkout, on one card, in turns: each checkout's repeats bit for
bit, the two checkouts' results side by side, and the times a call.

    python3 -m varanneal_tpu_torch.fe_ab OTHER_CHECKOUT OUT_DIR

``OTHER_CHECKOUT`` is the root of another checkout of the repo, e.g. the
parent commit unpacked by ``git archive`` into the git-ignored
``scratch_archive/``. As in ``solve_ab``, each turn is a child process
that imports one checkout's ``varanneal_tpu_torch`` and drives only its
public API (``kernels.fe.fe_consts``, the ``*_kernel`` wrappers,
``make_fe_pallas`` and ``api.Annealer``); the turns run other, this,
this, other, twice (the host's share of these times moves from turn to
turn). The inputs come from fixed seeds at chip_smoke.py phase 18's
timing shapes and phase 20's ensemble, with the scalar rf of rung 30:

- BASELINE config #1's trapezoid problem (Lorenz-96 D=20, N_data=161, F
  estimated), one member and B=4, float32: K6a and K6b;
- config #2's Hermite–Simpson problem (D=100, N_data=121, F estimated),
  one member, float32: K6c; B=8 in float64: K6d;
- config #2 with F fixed (nothing estimated), one member, float32.

Each case times each kernel's wrapper alone (the backward is
``sh_bwd_kernel`` or ``onestep_bwd_kernel`` where the checkout has one,
else the fused launch with its value partials unread), the fused launch
(``sh_vag_kernel``, ``onestep_vag_kernel``) where the checkout has it, and
``make_fe_pallas``'s value and gradient through autograd (one forward
and one backward launch), then its graph-free ``value_and_grad`` where
the checkout has it. The times are CUDA events around 1,000 calls (200
for the value and gradient), so they hold the wrapper's host work: these
launches take a few µs of device time, less than the host's part. The
per-block partials are compared summed over their blocks, (B,) values
and (B, NP) parameter gradients, since two checkouts may cut a member
into other blocks; the gradient rows entry by entry. Last, BASELINE
config #3 through the facade (NaKL, f64, ``engine='pallas'``, phase
27a's problem cut to :data:`FACADE_RUNGS` rungs): its wall and ms a loop
iteration, its records compared.
``solve_ab.run_turns`` and ``report`` run the turns and compare them: the
exit code is 0 when every turn repeats its checkout's first turn bit for
bit; differences between the two checkouts are reported, not failed.
"""

import sys

import numpy as np
import torch

#: Rungs of config #3's facade run (chip_smoke.py phase 27a runs 24).
FACADE_RUNGS = 20


def _events_ms(fn, n):
    """Mean time of ``fn`` in ms by CUDA events over ``n`` calls, after 20
    calls to warm up."""
    for _ in range(20):
        fn()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def child(checkout, out):
    """One turn: the checkout's K6 wrappers on the inputs; saves
    {"results": {name: [tensor, ...]}, "ms": {name: float}} to ``out``."""
    sys.path.insert(0, checkout)
    from varanneal_tpu_torch.kernels import fe
    from varanneal_tpu_torch.models import lorenz96
    from varanneal_tpu_torch.ops import build_spec
    from varanneal_tpu_torch.twin import lorenz96_twin
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    tw1 = lorenz96_twin(D=20, N_data=161, n_obs=8)
    tw2 = lorenz96_twin(D=100, N_data=121, n_obs=40, sigma=1.0)

    def spec(tw, D, disc, pidx):
        return build_spec(lorenz96, D, tw["Y"], tw["t"], tw["Lidx"],
                          tw["RM"], disc=disc, P=np.array([4.0]), pidx=pidx)

    cases = (("config #1 trapezoid f32 B=1", spec(tw1, 20, "trapezoid", [0]),
              f32, 1, 4e-6 * float(tw1["RM"]), 1.5),
             ("config #1 trapezoid f32 B=4", spec(tw1, 20, "trapezoid", [0]),
              f32, 4, 4e-6 * float(tw1["RM"]), 1.5),
             ("config #2 SH f32 B=1", spec(tw2, 100, "SimpsonHermite", [0]),
              f32, 1, 1e-4, 1.6),
             ("config #2 SH f64 B=8", spec(tw2, 100, "SimpsonHermite", [0]),
              f64, 8, 1e-4, 1.6),
             ("config #2 SH F fixed f32 B=1",
              spec(tw2, 100, "SimpsonHermite", []), f32, 1, 1e-4, 1.6))
    res, ms = {}, {}
    for name, sp, dtype, B, rf0, alpha in cases:
        rng = np.random.default_rng(18)
        X = torch.tensor(rng.normal(2.0, 2.0, (B, sp.N_f, sp.D)),
                         dtype=dtype, device=dev)
        pest = torch.tensor(4.0 + rng.normal(size=(B, sp.NPest)),
                            dtype=dtype, device=dev)
        rf = float(torch.tensor(rf0 * alpha ** 30, dtype=dtype))
        c = fe.fe_consts(sp, dtype, dev, block_n=64)
        # the backward: the checkout's lone backward where it has one, else
        # the fused launch's outputs without its value partials
        k = "sh" if sp.disc == "SimpsonHermite" else "onestep"
        vag = getattr(fe, f"{k}_vag_kernel", None)
        bwd = getattr(fe, f"{k}_bwd_kernel", None) or (
            lambda *a, vag=vag: vag(*a)[1:])
        kerns = [(f"{k}_fwd", getattr(fe, f"{k}_fwd_kernel")),
                 (f"{k}_bwd", bwd)]
        if vag is not None:
            kerns.append((f"{k}_vag", vag))
        for kern, fn in kerns:
            got = fn(X, pest, rf, c)
            got = [got] if isinstance(got, torch.Tensor) else list(got)
            # partials summed over their blocks: (B,) or (B, NP)
            if kern.endswith("fwd") or kern.endswith("vag"):
                got[0] = got[0].sum(-1)
            if not kern.endswith("fwd"):
                got[-1] = got[-1].sum(-1)
            res[f"{kern} {name}"] = got
            ms[f"{kern} {name}"] = _events_ms(
                lambda: fn(X, pest, rf, c), 1000)
        f = fe.make_fe_pallas(sp, block_n=64, device=dev)
        Xg = X.clone().requires_grad_(True)
        pg = pest.clone().requires_grad_(sp.NPest > 0)
        wrt = (Xg, pg) if sp.NPest else (Xg,)

        def value_and_grad():
            v = f(Xg, pg, rf)
            return [v.detach(), *torch.autograd.grad(v.sum(), wrt)]

        res[f"value+grad {name}"] = value_and_grad()
        ms[f"value+grad {name}"] = _events_ms(value_and_grad, 200)
        if hasattr(f, "value_and_grad"):
            res[f"value_and_grad {name}"] = list(
                f.value_and_grad(X, pest, rf))
            ms[f"value_and_grad {name}"] = _events_ms(
                lambda: f.value_and_grad(X, pest, rf), 200)
    torch.cuda.synchronize()
    res.update(_facade_config3(ms, dev))
    torch.save({"results": {k: [t.cpu() for t in v]
                            for k, v in res.items()}, "ms": ms}, out)
    return 0


def _facade_config3(ms, dev):
    """BASELINE config #3 through the facade as chip_smoke.py phase 27a
    runs it (examples/nakl.py's problem, f64, engine='pallas'), cut to its
    first FACADE_RUNGS rungs: the wall (a synchronize at each end), the
    loop's iterations and ms an iteration into ``ms``; returns the
    records (A by rung, niter, nfev) to compare."""
    import time
    from varanneal_tpu_torch.api import Annealer
    from varanneal_tpu_torch.models import NAKL_P_TRUE, nakl
    from varanneal_tpu_torch.twin import nakl_twin
    tw = nakl_twin(N=3001, dt=0.04, sigma=1.0, seed=7)
    P0 = np.asarray(NAKL_P_TRUE, float).copy()
    P0[[1, 2, 3, 4, 5]] = [80.0, 40.0, 30.0, -60.0, 0.5]
    X0 = np.column_stack([tw["V"][:, 0]] + [np.full(3001, 0.5)] * 3)
    bounds = [(-150.0, 70.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0),
              (50.0, 200.0), (20.0, 80.0), (5.0, 60.0), (-100.0, -50.0),
              (0.05, 1.0)]
    ann = Annealer(device=dev)
    ann.set_model(nakl, 4)
    ann.set_data(tw["V"], stim=tw["stim"], t=tw["t"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ann.anneal(X0, P0, alpha=1.6, beta_array=np.arange(FACADE_RUNGS),
               RM=1.0, RF0=1e-5, Lidx=[0], Pidx=[1, 2, 3, 4, 5],
               disc="SimpsonHermite", bounds=bounds,
               opt_args=dict(maxiter=5000), dtype=torch.float64,
               engine="pallas")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    niter = int(ann.niter_array.sum())
    tag = f"facade config #3 f64 rungs 0..{FACADE_RUNGS - 1}"
    ms[f"{tag}: wall s"] = wall
    ms[f"{tag}: ms an iteration"] = 1e3 * wall / max(niter, 1)
    return {tag: [torch.tensor(ann.A_array), torch.tensor(ann.niter_array),
                  torch.tensor(ann.nfev_array)]}


def main(argv):
    from varanneal_tpu_torch.solve_ab import report, run_turns
    return report(run_turns(__file__, *argv, rounds=2))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"] and len(sys.argv) == 4:
        sys.exit(child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1:]))
