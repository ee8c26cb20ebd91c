"""K6 on Lorenz-96, this checkout's wrappers against another checkout's, on
one card, in turns: each checkout's repeats bit for bit, the two
checkouts' results side by side, and the times a call.

    python3 -m varanneal_tpu_torch.fe_ab OTHER_CHECKOUT OUT_DIR

``OTHER_CHECKOUT`` is the root of another checkout of the repo, e.g. the
parent commit unpacked by ``git archive`` into the git-ignored
``scratch_archive/``. As in ``solve_ab``, each turn is a child process
that imports one checkout's ``varanneal_tpu_torch`` and drives only its
public K6 API (``kernels.fe.fe_consts``, the four ``*_kernel`` wrappers
and ``make_fe_pallas``); the turns run other, this, this, other, twice
(the host's share of these times moves from turn to turn). The
inputs come from fixed seeds at chip_smoke.py phase 18's timing shapes
and phase 20's ensemble, with the scalar rf of rung 30:

- BASELINE config #1's trapezoid problem (Lorenz-96 D=20, N_data=161, F
  estimated), one member, float32: K6a and K6b;
- config #2's Hermite–Simpson problem (D=100, N_data=121, F estimated),
  one member, float32: K6c; B=8 in float64: K6d;
- config #2 with F fixed (nothing estimated), one member, float32;

each kernel's wrapper alone, and ``make_fe_pallas``'s value and gradient
(one forward and one backward launch, as the facade's loop calls them).
The times are CUDA events around 1,000 calls (200 for the value and
gradient), so they hold the wrapper's host work: these launches take a
few µs of device time, less than the host's part. The parameter partials
are compared as (B, blocks) rows, whatever shape a checkout returns.
``solve_ab.run_turns`` and ``report`` run the turns and compare them: the
exit code is 0 when every turn repeats its checkout's first turn bit for
bit; differences between the two checkouts are reported, not failed.
"""

import sys

import numpy as np
import torch


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
        if sp.disc == "SimpsonHermite":
            fk, bk, kf, kb = (fe.sh_fwd_kernel, fe.sh_bwd_kernel, "sh_fwd",
                              "sh_bwd")
        else:
            fk, bk, kf, kb = (fe.onestep_fwd_kernel, fe.onestep_bwd_kernel,
                              "onestep_fwd", "onestep_bwd")
        bwd = list(bk(X, pest, rf, c))
        bwd[-1] = bwd[-1].reshape(B, -1)
        res[f"{kf} {name}"] = [fk(X, pest, rf, c)]
        res[f"{kb} {name}"] = bwd
        ms[f"{kf} {name}"] = _events_ms(lambda: fk(X, pest, rf, c), 1000)
        ms[f"{kb} {name}"] = _events_ms(lambda: bk(X, pest, rf, c), 1000)
        f = fe.make_fe_pallas(sp, block_n=64, device=dev)
        Xg = X.clone().requires_grad_(True)
        pg = pest.clone().requires_grad_(sp.NPest > 0)
        wrt = (Xg, pg) if sp.NPest else (Xg,)

        def value_and_grad():
            v = f(Xg, pg, rf)
            return [v.detach(), *torch.autograd.grad(v.sum(), wrt)]

        res[f"value+grad {name}"] = value_and_grad()
        ms[f"value+grad {name}"] = _events_ms(value_and_grad, 200)
    torch.cuda.synchronize()
    torch.save({"results": {k: [t.cpu() for t in v]
                            for k, v in res.items()}, "ms": ms}, out)
    return 0


def main(argv):
    from varanneal_tpu_torch.solve_ab import report, run_turns
    return report(run_turns(__file__, *argv, rounds=2))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"] and len(sys.argv) == 4:
        sys.exit(child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1:]))
