"""K2 and K3 of this checkout against another checkout's, on one card, in
turns: each checkout's repeats bit for bit, the two checkouts' results
side by side, and the times.

    python3 -m varanneal_tpu_torch.solve_ab OTHER_CHECKOUT OUT_DIR

``OTHER_CHECKOUT`` is the root of another checkout of the repo, e.g. the
parent commit unpacked by ``git archive`` into the git-ignored
``scratch_archive/``. Each turn is a child process that imports one
checkout's ``varanneal_tpu_torch`` and drives only its public wrappers
(``kernels.solve.ladder_kernel`` and ``solve_kernel``, in the layout that
checkout's planner gives), so the two checkouts' kernel interfaces may
differ. The turns run other, this, this, other. Each child builds its
inputs from fixed seeds, as chip_smoke.py does, at the main path's shape
(Lorenz-96 D=20, N_data=161, L=8, n_dof 3,221), and runs:

- the bench's f32 101-rung ladder (K3, B=4, m=5, maxiter 500), then a
  20-rung f64 tail from its end (K3);
- chip_smoke.py phase 8's and phase 12's short solves (maxiter 30, rf at
  β 0, 50, 100, f32 and f64): K2 unbounded, K3 with one rung and K2 in
  the box (-6, 6), F (3, 6);
- the fused path: 101 warm-started K2 launches from the ladder's start;
  and the facade's Quick start: 101 K2 launches in its box, one member;
- phase 8's short solves at β 50 at B = 4 and at B = 264 (two members an
  SM of an H100);
- short solves at BASELINE config #5's width (D = 400, N_data = 161, 160
  observed, B = 4, maxiter 30, β 0, 25, 50, f32 and f64): K2 and K3 with
  one rung, and their times at β 25 in f32. The other checkout may
  refuse the shape (its envelope's ValueError), which is recorded; any
  error of this checkout's kernels there fails the run.

Each child saves every result and its CUDA-event times in ``OUT_DIR``.
This process holds each turn's results, inputs included, to the first
turn of the same checkout bit for bit (the exit code is 0 when all
are). Between the two checkouts it reports, without failing, which
results differ in their bits and by how much: the differences in niter,
nfev and status, the largest relative difference of each float result
(f, A, x), and the bench's final_A_tail64 (member 0's action after the
f64 tail) of each; a checkout may change the evaluation's f32 sums by
design. It prints the times of both checkouts and last one JSON
object.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N_DATA, N_OBS, ALPHA, N_BETA, TAIL = 20, 161, 8, 1.5, 101, 20
BOX_TEST = (-6.0, 6.0, 3.0, 6.0)        # states lo/hi, F lo/hi
BOX_FACADE = (-10.0, 10.0, 2.0, 12.0)


def _events_ms(fn, n):
    """Mean time of ``fn`` in ms by CUDA events over ``n`` calls, after
    one call to warm up."""
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
    """One turn: the checkout's wrappers on the inputs; saves
    {"results": {name: [tensor, ...]}, "ms": {name: float}} to ``out``."""
    sys.path.insert(0, checkout)
    from varanneal_tpu_torch.anneal.ladder import rung_rf
    from varanneal_tpu_torch.kernels import ag, solve
    from varanneal_tpu_torch.models import lorenz96
    from varanneal_tpu_torch.ops import build_spec, pack
    from varanneal_tpu_torch.opt import LBFGSOptions
    from varanneal_tpu_torch.parallel import random_ensemble_inits
    from varanneal_tpu_torch.twin import lorenz96_twin
    dev = torch.device("cuda", torch.cuda.current_device())
    tw = lorenz96_twin(D=D, N_data=N_DATA, n_obs=N_OBS)
    spec = build_spec(lorenz96, D, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                      disc="trapezoid", P=np.array([4.0]), pidx=[0])
    rf0 = 4e-6 * tw["RM"]
    c = {dt: ag.ag_consts(spec, dev, dt)
         for dt in (torch.float32, torch.float64)}

    def draws(B, dt):      # chip_smoke.member_draws(spec, tw, 0, B)
        rng = np.random.default_rng(0)
        rows = np.arange(spec.N_data) * spec.obs_stride
        out = []
        for _ in range(B):
            X = rng.normal(2.0, 2.0, (spec.N_f, spec.D))
            X[np.ix_(rows, np.asarray(spec.Lidx))] = tw["Y"] + rng.normal(
                0, 0.3, tw["Y"].shape)
            out.append(pack(spec, X, np.array([4.0 + rng.normal()])))
        return torch.tensor(np.stack(out), dtype=dt, device=dev)

    def box(b, dt):
        n = spec.n_dof
        return tuple(torch.tensor([v] * (n - 1) + [f], dtype=dt, device=dev)
                     for v, f in ((b[0], b[2]), (b[1], b[3])))

    def as_list(r):          # an LBFGSResult or (X, records)
        if isinstance(r, tuple) and isinstance(r[1], dict):
            return [r[0]] + [r[1][k] for k in sorted(r[1])]
        return [r.x, r.f, r.g, r.niter, r.nfev, r.status, r.pgnorm]

    opts = LBFGSOptions(m=5, maxiter=500, maxls=20, pgtol=1e-4, ftol=1e-6)
    opts64 = LBFGSOptions(m=5, maxiter=2000, maxls=20, pgtol=1e-8,
                          ftol=2.22e-9)
    opts_s = LBFGSOptions(maxiter=30, m=5, pgtol=1e-4, ftol=1e-6)
    f32, f64 = torch.float32, torch.float64
    rf0_32 = np.float32(rf0)
    rfs = [rung_rf(rf0_32, ALPHA, b, f32) for b in range(N_BETA)]
    rfs_t = torch.tensor(rfs, device=dev)
    rfs64 = torch.tensor([rung_rf(np.float64(rf0_32), ALPHA, b, f64)
                          for b in range(N_BETA - TAIL, N_BETA)],
                         dtype=f64, device=dev)
    xp0 = torch.tensor(random_ensemble_inits(spec, 4, seed=3,
                                             dtype=np.float32), device=dev)
    res = {"inputs": [xp0, rfs_t, rfs64, draws(264, f32)]}
    ms = {}

    def k3_main():
        return solve.ladder_kernel(xp0, rfs_t, c[f32], opts)

    res["K3 f32 ladder"] = as_list(k3_main())
    ms["K3 f32 101-rung launch"] = _events_ms(k3_main, 2)
    x64 = res["K3 f32 ladder"][0].double()
    res["K3 f64 tail"] = as_list(solve.ladder_kernel(x64, rfs64, c[f64],
                                                     opts64))
    for dt in (f32, f64):
        Z = draws(4, dt)
        lo, hi = box(BOX_TEST, dt)
        for beta in (0, 50, 100):
            rf = rung_rf(rf0_32 if dt == f32 else rf0, ALPHA, beta, dt)
            tag = f"{str(dt)[6:]} beta {beta}"
            rft = torch.tensor([rf], dtype=dt, device=dev)
            res[f"K2 short {tag}"] = as_list(
                solve.solve_kernel(Z, rf, c[dt], opts_s))
            res[f"K3 short {tag}"] = as_list(
                solve.ladder_kernel(Z, rft, c[dt], opts_s))
            res[f"K2 bounded short {tag}"] = as_list(
                solve.solve_kernel(Z, rf, c[dt], opts_s, lo, hi))

    def chain(XP, lo=None, hi=None):
        x, out = XP, []
        for rf in rfs:
            r = solve.solve_kernel(x, rf, c[f32], opts, lo, hi)
            x = r.x
            out += [r.f, r.niter, r.nfev, r.status]
        return [x] + out

    box_q = box(BOX_FACADE, f32)
    for tag, args in (("fused", (xp0,)), ("bounded", (xp0[:1], *box_q))):
        res[f"K2 {tag} chain"] = chain(*args)
        ms[f"K2 {tag} a launch"] = _events_ms(lambda: chain(*args),
                                              2) / N_BETA
    rf50 = rung_rf(rf0_32, ALPHA, 50, f32)
    for B in (4, 264):
        Z = draws(B, f32)
        res[f"K2 short B={B}"] = as_list(
            solve.solve_kernel(Z, rf50, c[f32], opts_s))
        ms[f"K2 short solves B={B}"] = _events_ms(
            lambda: solve.solve_kernel(Z, rf50, c[f32], opts_s), 4)
    # config #5's width; a checkout whose kernels refuse it records that
    tw5 = lorenz96_twin(D=400, N_data=N_DATA, n_obs=160)
    spec5 = build_spec(lorenz96, 400, tw5["Y"], tw5["t"], tw5["Lidx"],
                       tw5["RM"], disc="trapezoid", P=np.array([4.0]),
                       pidx=[0])
    rng = np.random.default_rng(0)
    Z5 = np.stack([pack(spec5, rng.normal(2.0, 2.0, (N_DATA, 400)),
                        np.array([4.0 + rng.normal()])) for _ in range(4)])
    res["D=400 inputs"] = [torch.tensor(Z5)]
    # only the other checkout may refuse the shape, and only by the
    # envelope's ValueError; any error of this checkout fails the turn
    mine = os.path.realpath(checkout) == os.path.realpath(ROOT)
    try:
        for dt in (f32, f64):
            c5 = ag.ag_consts(spec5, dev, dt)
            Z = torch.tensor(Z5, dtype=dt, device=dev)
            for beta in (0, 25, 50):
                rf = rung_rf(4e-6 * tw5["RM"], ALPHA, beta, dt)
                rft = torch.tensor([rf], dtype=dt, device=dev)
                tag = f"D=400 {str(dt)[6:]} beta {beta}"
                res[f"K2 short {tag}"] = as_list(
                    solve.solve_kernel(Z, rf, c5, opts_s))
                res[f"K3 short {tag}"] = as_list(
                    solve.ladder_kernel(Z, rft, c5, opts_s))
                if dt == f32 and beta == 25:
                    ms["K2 short solves D=400"] = _events_ms(
                        lambda: solve.solve_kernel(Z, rf, c5, opts_s), 4)
        torch.cuda.synchronize()
    except ValueError as e:
        if mine:
            raise
        res["D=400 refused"] = [torch.tensor([1])]
        print(f"D=400: {e}")
    torch.cuda.synchronize()
    nfev = res["K3 f32 ladder"][4]
    ms["K3 us an evaluation"] = (1e3 * ms["K3 f32 101-rung launch"]
                                 / int(nfev.sum(dim=1).max()))
    torch.save({"results": {k: [t.cpu() for t in v]
                            for k, v in res.items()}, "ms": ms}, out)
    return 0


def run_turns(script, other, out_dir, rounds=1):
    """Run ``script --child ROOT PATH`` for the turns other, this, this,
    other (``rounds`` times over) and compare them: each turn's results
    against its checkout's first turn bit for bit, this checkout's first
    turn against the other's. Prints the card and both checkouts' mean
    times; returns a dict of the card, the first turns' results
    (``first``), the repeats' verdicts (``bits``), the differences
    (``diffs``), the results only one checkout has (``only``), the mean
    times (``ms``) and each turn's times (``runs``)."""
    other, out_dir = os.path.abspath(other), os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    turns = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)] * rounds
    stem = os.path.splitext(os.path.basename(script))[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    got = []
    for i, (tag, root) in enumerate(turns):
        path = os.path.join(out_dir, f"{stem}_turn{i}_{tag}.pt")
        # -P: the script's own directory does not go on sys.path, so the
        # child imports the package of ``root`` alone
        proc = subprocess.run([sys.executable, "-P", script, "--child",
                               root, path], capture_output=True, text=True,
                              timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr)
            raise SystemExit(f"{stem}: the {tag} turn failed")
        got.append((tag, torch.load(path)))
    first = {tag: got[turns.index((tag, root))][1]["results"]
             for tag, root in turns}
    bits = {}
    for i, (tag, g) in enumerate(got):
        if g["results"] is first[tag]:
            continue
        for k, v in g["results"].items():
            ref = first[tag].get(k)
            bits[f"turn {i} ({tag}): {k}"] = (
                ref is not None and len(v) == len(ref)
                and all(torch.equal(a, b) for a, b in zip(v, ref)))
    diffs = {k: _difference(first["other"][k], v)
             for k, v in first["this"].items() if k in first["other"]}
    only = sorted(set(first["this"]) ^ set(first["other"]))
    ms = {tag: {k: float(np.mean([g["ms"][k] for t, g in got if t == tag]))
                for k in next(g["ms"] for t, g in got if t == tag)}
          for tag in ("other", "this")}
    for k in ms["this"]:
        o = ms["other"].get(k)
        print(f"{k}: other "
              + (f"{o:.4f}" if o is not None else "not run")
              + f", this {ms['this'][k]:.4f}"
              + (f" ({o / ms['this'][k]:.3f}x)" if o is not None else ""))
    return dict(card=smi, first=first, bits=bits, diffs=diffs, only=only,
                ms=ms, runs={f"{i} {t}": g["ms"]
                             for i, (t, g) in enumerate(got)})


def report(r, **extra):
    """Print which results the two checkouts share bit for bit, how the
    others differ, and which repeats differ from their first turn, then
    one JSON line (with ``extra``); returns the exit code: 0 when every
    repeat is bit-identical."""
    print("this against other, bit-identical: "
          + (", ".join(k for k, d in r["diffs"].items() if d is None)
             or "none"))
    for k, d in r["diffs"].items():
        if d is not None:
            print(f"this against other, {k}: {d}")
    if r["only"]:
        print("in one checkout only: " + ", ".join(r["only"]))
    print("DIFFERENT from the same checkout's first turn: "
          + (", ".join(k for k, v in r["bits"].items() if not v)
             or "none"))
    ok = all(r["bits"].values())
    print(json.dumps(dict(card=r["card"], repeats_bit_identical=ok,
                          checks=len(r["bits"]), **extra,
                          this_vs_other=r["diffs"], only_in_one=r["only"],
                          ms=r["ms"], runs=r["runs"])))
    return 0 if ok else 1


def main(argv):
    r = run_turns(__file__, *argv)
    tails = {tag: float(r["first"][tag]["K3 f64 tail"][1][0, -1])
             for tag in ("other", "this")}
    print(f"final_A_tail64 (member 0): other {tails['other']:.6f}, this "
          f"{tails['this']:.6f}")
    return report(r, final_A_tail64=tails)


def _difference(a, b):
    """None where the lists of tensors ``a`` and ``b`` are bit-identical;
    else, per position that differs, the integer results' summed
    difference and number of differing entries, or the float results'
    largest difference relative to the largest magnitude of ``a``."""
    if len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b)):
        return None
    out = {}
    for i, (u, v) in enumerate(zip(a, b)):
        if torch.equal(u, v):
            continue
        if u.is_floating_point():
            scale = float(u.abs().max()) or 1.0
            out[i] = f"max rel {float((v - u).abs().max()) / scale:.3e}"
        else:
            out[i] = (f"sum {int(v.sum()) - int(u.sum()):+d}, "
                      f"{int((u != v).sum())} entries differ")
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"] and len(sys.argv) == 4:
        sys.exit(child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1:]))
