"""Drive the PyTorch/CUDA port (varanneal_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; nothing is installed first. Phases, each
timed on its own line:

1. device: the card's name, count, power limit, the torch and nvcc
   versions; no CUDA device -> exit 1 before any result is printed;
2. build: K1 (kernels/csrc/ag_kernel.cu) and K2/K3
   (kernels/csrc/solve_kernel.cu), one nvcc each, started together, into
   plain-C shared libraries, with nvcc's -Xptxas -v report (registers,
   spills, shared memory);
3. K1 against its plain PyTorch version on the card at the main path's
   shape (Lorenz-96 D=20, N=161, L=8, B=4; data-informed draws from numpy
   seed 0; rf at β = 0, 50, 100): f64 to 1e-12 and f32 to 2e-5 relative;
   then 1000 launches each of the kernel, the plain version and the
   autograd action's value+grad, timed with CUDA events;
4. an f64 10-rung ladder (B=2, from near the twin's truth, rf0 = RM,
   every rung solved to pgtol 1e-8) through the kernel and through the
   plain version: the action at every mutually converged rung must agree
   to 1e-8 relative;
5. the main path, as bench.py runs BASELINE config #1 with
   BENCH_SOLVER=xla BENCH_ENGINE=ag BENCH_DIRECTION=compact: 101 f32
   rungs (α=1.5, rf0=4e-6·RM, m=5, maxiter 500, maxls 20, pgtol 1e-4,
   ftol 1e-6) over 4 members from random_ensemble_inits(seed=3), then the
   20-rung f64 tail through K1 in f64 (maxiter 2000, pgtol 1e-8, ftol
   2.22e-9). The kernel's launch count is zeroed just before and read
   just after the f32 ladder: every evaluation of every rung rides one
   launch, so the count must reach, per rung, the most evaluations any
   member made;
6. K1 against its plain version on the main path's own minimizers (rungs
   0, 60, 100), where the gradient is a small difference of large terms
   and the top rungs' residuals are f32 round-off: A and gradient within
   4x the plain f32 version's own error against f64 on the same inputs
   (the max abs kernel-vs-plain error goes into the kernel line),
   and the first 50 iterations of rung 60 again under torch.profiler:
   device busy share, K1's share of the wall time, the costliest device
   kernels;
7. K2 and K3 against their plain versions in f64 at the main shape
   (phase 3's draws): short solves (maxiter 30, m=5, pgtol 1e-4, ftol
   1e-6, rf at β = 0, 50, 100) through K2, through K3 with one rung and
   through the plain version: identical niter, nfev and status per
   member, x within 1e-8 relative; then phase 4's f64 10-rung ladder
   (4 members) through K3, through K2 via the ladder's rung_solver hook
   and through the plain ladder: A within 1e-8 relative at every
   mutually converged rung; K2 and K3 launched twice give the same bits;
8. the same short solves in f32: identical niter, nfev and status per
   member, and every member's f within 1e-4 relative of the plain
   version's, or, where the plain version itself moves further under
   another summation order (the top rungs, whose action is f32
   round-off), within twice what it moves: the plain version on the CPU
   is that witness (f32 iterates are not compared); K2, K3 (the three
   rungs warm-started in one launch) and their plain versions timed on
   them;
9. the new path, bench.py's default as the port runs it
   (varanneal_tpu_torch.bench.main, BENCH_SOLVER=ladder, B=4 from
   random_ensemble_inits(seed=3), member 0 being bench.py's single
   init): launch counts zeroed before, then exactly one K3 launch per
   ladder call and no K1 launch during the f32 ladders; records (4, 101)
   and finite; final_A_tail64 of member 0 within 1e-2 relative of
   16.284792 (JAX on a TPU v5e, an accuracy anchor); then the same with
   BENCH_SOLVER=fused (101 K2 launches per call). Before both, one K3
   ladder call of that path (the same inputs, outside the counted runs)
   is timed by CUDA events and run under torch.profiler, in a child
   process (``chip_smoke.py --profile-k3``): the device's busy share and
   K3's device time.

The last two lines are one JSON object per kernel (name, route, source,
the TPU kernel it replaces, launches on its path, max abs error, times,
bound; K3's ms and bound are those of phase 8's three-rung launch, and
main_ms / main_bound_ms those of its 101-rung launch on the new path)
and the result line {"ok": true, "device": {...}}. Any failure raises,
and the script exits non-zero before that line.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# The card's rates, from NVIDIA's H100 SXM data sheet: HBM bytes/s and
# f32 and f64 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# final_A_tail64 of bench.py's single init: JAX on a TPU v5e
# (BENCH_r05.json), an accuracy anchor and not a time
JAX_FINAL_A_TAIL64 = 16.284792

MAIN = dict(D=20, N_data=161, n_obs=8, B=4, n_beta=101, alpha=1.5,
            tail=20)


def device_us(evt):
    """Self device time of a profiler row in µs, across torch versions."""
    for k in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, k):
            return float(getattr(evt, k))
    return 0.0


def events_ms(fn, n=1000, warm=20):
    """Mean time of ``fn`` on the card in ms, by CUDA events around ``n``
    calls after ``warm`` calls."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def k1_ops(spec):
    """Operations of one member's action+gradient in K1's arithmetic: 15
    per residual entry forward, 4 per observation for ME, 15 per state
    entry for the adjoint, 5 per observation for ME's gradient."""
    n_obs = spec.N_data * spec.L
    return (15 * (spec.N_f - 1) * spec.D + 4 * n_obs + 15 * spec.N_f * spec.D
            + 5 * n_obs)


def solve_bound(spec, dtype, B, launches, nfev, niter, m, rungs):
    """Least time of one solve-kernel launch, from the work this run's
    data needed: each input read and each output written once over HBM;
    the operations of ``nfev`` evaluations (K1's arithmetic plus the trial
    point and the directional derivative, 4 per entry) and ``niter``
    iterations (the two-loop direction over a full m-history, 12 per
    entry and pair, and 15 per entry for the step, the curvature gate,
    the history write and the norms) over the card's rate for ``dtype``,
    divided over ``launches``. Returns (ms, bound_by, bytes, operations)
    per launch."""
    s = torch.finfo(dtype).bits // 8
    n, n_obs = spec.n_dof, spec.N_data * spec.L
    inputs = B * n * s + 2 * n_obs * s + 4 * (spec.L + spec.D) + rungs * s
    if rungs == 1:      # K2: x, g, [f, pgnorm], [niter, nfev, status]
        outputs = 2 * B * n * s + B * (2 * s + 12)
    else:               # K3: x and the (rungs, 3) + (rungs, 3) records
        outputs = B * n * s + B * rungs * (3 * s + 12)
    nbytes = inputs + outputs
    nops = (nfev * (k1_ops(spec) + 4 * n)
            + niter * n * (12 * m + 15)) // launches
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FLOPS[dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, nops
    return t_ops, "operations", nbytes, nops


def main_problem():
    """The main path's twin, spec and rf0 (BASELINE config #1)."""
    from varanneal_tpu_torch.models import lorenz96
    from varanneal_tpu_torch.ops import build_spec
    from varanneal_tpu_torch.twin import lorenz96_twin
    tw = lorenz96_twin(D=MAIN["D"], N_data=MAIN["N_data"],
                       n_obs=MAIN["n_obs"])
    spec = build_spec(lorenz96, MAIN["D"], tw["Y"], tw["t"], tw["Lidx"],
                      tw["RM"], disc="trapezoid", P=np.array([4.0]),
                      pidx=[0])
    return tw, spec, 4e-6 * tw["RM"]


def profile_k3():
    """One K3 call of the new path (f32, every rung, B members from
    random_ensemble_inits(seed=3)), timed by CUDA events and run again
    under torch.profiler; prints one JSON line. Runs in a process of its
    own: in the long main process the profiler stopped recording device
    activity by this point (runtime calls only), which a fresh process
    does not show."""
    from varanneal_tpu_torch.anneal.ladder import rung_rf
    from varanneal_tpu_torch.kernels import solve
    from varanneal_tpu_torch.opt import LBFGSOptions
    from varanneal_tpu_torch.parallel import random_ensemble_inits
    dev = torch.device("cuda", torch.cuda.current_device())
    tw, spec, rf0 = main_problem()
    opts = LBFGSOptions(m=5, maxiter=500, maxls=20, pgtol=1e-4, ftol=1e-6)
    lad = solve.make_ladder_solver(spec, opts, MAIN["n_beta"], device=dev)
    rfs = np.array([rung_rf(np.float32(rf0), MAIN["alpha"], b,
                            torch.float32) for b in range(MAIN["n_beta"])])
    xp0 = torch.tensor(random_ensemble_inits(spec, MAIN["B"], seed=3,
                                             dtype=np.float32), device=dev)
    ms = events_ms(lambda: lad(xp0, rfs), n=1, warm=1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_p = time.perf_counter()
        _, rec = lad(xp0, rfs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t_p) * 1e6
    dev_rows = [(device_us(e), e.key) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    print(json.dumps(dict(
        ms=ms, wall_us=wall_us, busy_us=sum(r[0] for r in dev_rows),
        k3_us=sum(r[0] for r in dev_rows if "l96_ladder" in r[1]),
        nfev=rec["nfev"].sum(dim=1).tolist(),
        niter=rec["niter"].sum(dim=1).tolist())))
    return 0


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main():
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from varanneal_tpu_torch.kernels import _build, ag, solve
    from varanneal_tpu_torch.ops import make_action, pack
    from varanneal_tpu_torch.ops import value_and_grad
    from varanneal_tpu_torch.opt import LBFGSOptions, lbfgs_minimize
    from varanneal_tpu_torch.anneal import run_ladder
    from varanneal_tpu_torch.anneal.ladder import rung_rf
    from varanneal_tpu_torch.parallel import (make_ensemble_ladder,
                                              random_ensemble_inits)

    # ---- 1. device -------------------------------------------------------
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    nvcc_v = subprocess.run([_build.nvcc(), "--version"],
                            capture_output=True, text=True, timeout=60,
                            check=True).stdout.strip().splitlines()[-1]
    print(f"device: {name}; count {torch.cuda.device_count()}")
    print(smi)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc_v}")
    phase("1 device", t0)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build(["ag_kernel", "solve_kernel"])
    for b in built.values():
        print(f"nvcc build of {b.path.name}: {b.seconds:.2f} s "
              "(the two builds run in parallel)")
        for line in b.log.splitlines():
            if ("Compiling entry" in line or "Used" in line
                    or "bytes stack frame" in line):
                print(f"ptxas {b.name}:", line.strip())
    phase("2 build", t0)

    tw, spec, rf0 = main_problem()

    # ---- 3. kernel vs plain at the main path's shape -----------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    draws = []
    for _ in range(MAIN["B"]):
        X = rng.normal(2.0, 2.0, (spec.N_f, spec.D))
        rows = np.arange(spec.N_data) * spec.obs_stride
        X[np.ix_(rows, np.asarray(spec.Lidx))] = tw["Y"] + rng.normal(
            0, 0.3, tw["Y"].shape)
        draws.append(pack(spec, X, np.array([4.0 + rng.normal()])))
    draws = np.stack(draws)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 2e-5)):
        c = ag.ag_consts(spec, dev, dtype)
        Z = torch.tensor(draws, dtype=dtype, device=dev)
        for beta in (0, 50, 100):
            rf = float(rf0 * MAIN["alpha"] ** beta)
            A, G = ag.ag_kernel(Z, rf, c)
            torch.cuda.synchronize()
            A_r, G_r = ag.ag_reference(Z, rf, c)
            rel_a = float(torch.max(torch.abs(A - A_r) / torch.abs(A_r)))
            scale = torch.amax(torch.abs(G_r), dim=1, keepdim=True)
            rel_g = float(torch.max(torch.abs(G - G_r) / scale))
            print(f"K1 {str(dtype)[6:]} beta={beta}: A rel err {rel_a:.3e},"
                  f" gradient rel err {rel_g:.3e} (bound {tol:g})")
            check(rel_a <= tol and rel_g <= tol,
                  f"K1 {dtype} disagrees with its plain version at "
                  f"beta={beta}")

    c32 = ag.ag_consts(spec, dev, torch.float32)
    Z32 = torch.tensor(draws, dtype=torch.float32, device=dev)
    rf_t = float(np.float32(rf0 * MAIN["alpha"] ** 50))
    act32, _ = make_action(spec, device=dev)
    vag32 = value_and_grad(act32)

    ms_kernel = events_ms(lambda: ag.ag_kernel(Z32, rf_t, c32))
    ms_plain = events_ms(lambda: ag.ag_reference(Z32, rf_t, c32))
    ms_autograd = events_ms(lambda: vag32(Z32, rf_t))
    print(f"K1 f32 B={MAIN['B']}: kernel {ms_kernel:.5f} ms/launch, plain "
          f"{ms_plain:.5f} ms, autograd action value+grad "
          f"{ms_autograd:.5f} ms (CUDA events, 1000 calls each)")

    # the kernel's own device time (CUPTI, through torch.profiler): the
    # event timing above also counts the host's time to enqueue a launch
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            ag.ag_kernel(Z32, rf_t, c32)
        torch.cuda.synchronize()
    k1_dev = [(device_us(e), e.count) for e in prof.key_averages()
              if "l96_ag_trap" in e.key]
    if k1_dev and k1_dev[0][0] > 0:
        print(f"K1 f32 device time per launch (torch.profiler): "
              f"{k1_dev[0][0] / k1_dev[0][1] / 1e3:.5f} ms over "
              f"{k1_dev[0][1]} launches")
    else:
        print("K1 f32 device time per launch (torch.profiler): "
              "not measured (no device events)")

    # least time for the same work: each input read once, each output
    # written once, over HBM; the operations the kernel's arithmetic needs
    # (15 per residual entry forward, 4 per observation for ME, 15 per
    # state entry for the adjoint, 5 per observation for ME's gradient)
    # over the f32 rate
    B, n_dof, N, D = MAIN["B"], spec.n_dof, spec.N_f, spec.D
    s = 4
    n_obs = spec.N_data * spec.L
    nbytes = (B * n_dof * s + 2 * n_obs * s + 4 * (spec.L + D)
              + B * s + B * n_dof * s)
    nops = B * (15 * (N - 1) * D + 4 * n_obs + 15 * N * D + 5 * n_obs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FLOPS[torch.float32] * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    print(f"K1 bound: {nbytes} bytes, {nops} operations -> "
          f"{bound_ms:.3e} ms ({bound_by})")
    phase("3 kernel vs plain", t0)

    # ---- 4. f64 short ladder: kernel vs plain ------------------------------
    # Both ladders must reach the same minima to 1e-8, so every rung is
    # solved to pgtol (ftol off) from near the truth with the model error
    # weighted like the data (rf0 = RM). An ftol stop, or a rung at low rf
    # (flat, data-dominated), ends at a point that moves far more than
    # 1e-8 under rounding alone; two correct f64 implementations could not
    # pass there.
    t0 = time.perf_counter()
    act64k, parts64 = ag.make_action_ag(spec, device=dev,
                                        dtype=torch.float64)
    c64 = act64k.consts

    def plain64(XP, rf):
        return ag.ag_reference(XP, rf, c64)[0]

    plain64.value_and_grad = lambda XP, rf: ag.ag_reference(XP, rf, c64)
    opts_t = LBFGSOptions(m=5, maxiter=3000, maxls=20, pgtol=1e-8, ftol=0.0)
    rng = np.random.default_rng(1)
    xp2 = torch.tensor(np.stack([
        pack(spec, tw["traj"] + 0.3 * rng.normal(size=tw["traj"].shape),
             np.array([tw["F"] + 0.5 * rng.normal()])) for _ in range(2)]),
        device=dev)
    runs = []
    for a in (act64k, plain64):
        runs.append(make_ensemble_ladder(a, parts64, np.arange(10),
                                         float(tw["RM"]), MAIN["alpha"],
                                         opts=opts_t, device=dev)(xp2))
    stat_k = runs[0].status.cpu().numpy()
    stat_p = runs[1].status.cpu().numpy()
    A_k, A_p = runs[0].A.cpu().numpy(), runs[1].A.cpu().numpy()
    both = (stat_k <= 1) & (stat_p <= 1)
    rel = np.abs(A_k - A_p) / np.abs(A_p)
    print(f"f64 ladder: mutually converged rungs {int(both.sum())}/"
          f"{both.size}; max rel A difference {rel[both].max():.3e}; "
          f"niter kernel {runs[0].niter.sum().item()}, plain "
          f"{runs[1].niter.sum().item()}")
    check(both.mean() >= 0.8, f"too few converged rungs: {stat_k} {stat_p}")
    check(np.all(rel[both] <= 1e-8),
          f"f64 ladder through the kernel disagrees: {rel}")
    phase("4 f64 ladder kernel vs plain", t0)

    # ---- 5. the main path ---------------------------------------------------
    t0 = time.perf_counter()
    action, parts = ag.make_action_ag(spec, device=dev, dtype=torch.float32)
    opts = LBFGSOptions(m=5, maxiter=500, maxls=20, pgtol=1e-4, ftol=1e-6,
                        direction="compact")
    ladder = make_ensemble_ladder(action, parts, np.arange(MAIN["n_beta"]),
                                  np.float32(rf0), MAIN["alpha"], opts=opts,
                                  store_paths=True, device=dev)
    xp0 = torch.tensor(random_ensemble_inits(spec, MAIN["B"], seed=3,
                                             dtype=np.float32), device=dev)
    ag.LAUNCHES = 0
    t_lad = time.perf_counter()
    res = ladder(xp0)
    torch.cuda.synchronize()
    wall_f32 = time.perf_counter() - t_lad
    launches = ag.LAUNCHES

    # the f64 tail through K1 in f64: the same function as the autograd
    # action (phase 3 holds the two to 1e-12), ~70x cheaper an evaluation
    t_tail = time.perf_counter()
    act64, parts64a = ag.make_action_ag(spec, device=dev,
                                        dtype=torch.float64)
    opts64 = LBFGSOptions(maxiter=2000, pgtol=1e-8, ftol=2.22e-9,
                          direction="compact")
    tail = run_ladder(act64, parts64a, res.XP.double(),
                      np.arange(MAIN["n_beta"] - MAIN["tail"],
                                MAIN["n_beta"]), rf0, MAIN["alpha"],
                      opts=opts64, store_paths=False, device=dev)
    torch.cuda.synchronize()
    wall_tail = time.perf_counter() - t_tail

    nfev = res.nfev.cpu().numpy()                  # (B, n_beta)
    total_nfev = int(nfev.sum())
    lockstep_nfev = int(nfev.max(axis=0).sum())
    A_tail = tail.A.cpu().numpy()
    final_A_tail64 = float(A_tail[0, -1])
    print(f"main path f32 ladder: {MAIN['n_beta']} rungs x {MAIN['B']} "
          f"members in {wall_f32:.2f} s; total nfev {total_nfev} (sum over "
          f"members), per-rung max over members summed {lockstep_nfev}; "
          f"K1 launches {launches}")
    print(f"main path f64 tail: {MAIN['tail']} rungs in {wall_tail:.2f} s; "
          f"nfev {int(tail.nfev.sum())}")
    print(f"final_A_tail64 member 0: {final_A_tail64:.6f} (JAX on TPU v5e, "
          f"BENCH_r05: {JAX_FINAL_A_TAIL64}); members: "
          + ", ".join(f"{a:.6f}" for a in A_tail[:, -1])
          + f"; mean {A_tail[:, -1].mean():.6f}")
    print(f"f32 ladder statuses (count per code 0..3): "
          f"{np.bincount(res.status.cpu().numpy().ravel(), minlength=4)}")
    check(launches >= lockstep_nfev > 0,
          f"main path did not go through K1: {launches} launches for "
          f"{lockstep_nfev} evaluations")
    for nm, t in (("XP", res.XP), ("A", res.A), ("tail XP", tail.XP),
                  ("tail A", tail.A)):
        check(bool(torch.isfinite(t).all()), f"non-finite {nm}")
    check(tuple(res.A.shape) == (MAIN["B"], MAIN["n_beta"])
          and tuple(tail.A.shape) == (MAIN["B"], MAIN["tail"]),
          "unexpected record shapes")
    phase("5 main path", t0)

    # ---- 6. K1 on the main path's own inputs; one rung under the profiler
    t0 = time.perf_counter()
    # At a minimizer the gradient is a small difference of large terms,
    # and at the top rungs the residuals are f32 round-off themselves, so
    # the kernel's f32 error is judged against the exact (f64) value on
    # the same inputs: within 4x the plain f32 version's own error.
    c64m = ag.ag_consts(spec, dev, torch.float64)
    max_abs = 0.0
    for k in (0, 60, MAIN["n_beta"] - 1):
        rf_k = rung_rf(np.float32(rf0), MAIN["alpha"], k, torch.float32)
        XP_k = res.paths[:, k].contiguous()
        A, G = ag.ag_kernel(XP_k, rf_k, c32)
        A_r, G_r = ag.ag_reference(XP_k, rf_k, c32)
        A_x, G_x = ag.ag_reference(XP_k.double(), rf_k, c64m)
        errs = [float(torch.max(torch.abs(u.double() - ex)))
                for u, ex in ((A, A_x), (A_r, A_x), (G, G_x), (G_r, G_x))]
        err = max(float(torch.max(torch.abs(A - A_r))),
                  float(torch.max(torch.abs(G - G_r))))
        max_abs = max(max_abs, err)
        print(f"K1 f32 at the main path's minimizer of rung {k}: max abs "
              f"err vs plain {err:.3e}; error vs f64, kernel / plain f32: "
              f"A {errs[0]:.3e} / {errs[1]:.3e}, gradient {errs[2]:.3e} / "
              f"{errs[3]:.3e} (bound 4x plain)")
        check(errs[0] <= 4.0 * errs[1] and errs[2] <= 4.0 * errs[3],
              f"K1 disagrees with its plain version at rung {k}")

    k_prof = 60
    rf_p = rung_rf(np.float32(rf0), MAIN["alpha"], k_prof, torch.float32)
    xp_p = res.paths[:, k_prof - 1].contiguous()
    vag = action.value_and_grad
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_p = time.perf_counter()
        rp = lbfgs_minimize(lambda z: vag(z, rf_p), xp_p,
                            opts=dataclasses.replace(opts, maxiter=50),
                            device=dev)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t_p) * 1e6
    # device-side rows only (kernels, copies); a CPU op's row repeats the
    # time of the kernels it launched
    dev_rows = sorted(((device_us(e), e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      reverse=True)
    busy = sum(r[0] for r in dev_rows)
    k1_us = sum(r[0] for r in dev_rows if "l96_ag_trap" in r[2])
    print(f"profiled: the first {int(rp.niter.max())} iterations of rung "
          f"{k_prof} (4 members, {int(rp.nfev.max())} evaluations of the "
          f"slowest member): wall {wall_p / 1e3:.1f} ms under the profiler; "
          f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_p:.1f} %), "
          f"K1 {k1_us / 1e3:.2f} ms ({100 * k1_us / wall_p:.1f} %); "
          f"{sum(r[1] for r in dev_rows)} device kernels in "
          f"{len(dev_rows)} kinds")
    for us, cnt, key in dev_rows[:6]:
        print(f"  device {us / 1e3:8.3f} ms  {cnt:6d}x  {key[:70]}")
    phase("6 main-path inputs and profile", t0)

    # ---- 7. K2 and K3 vs their plain versions in f64 ------------------------
    t0 = time.perf_counter()
    opts_s = LBFGSOptions(maxiter=30, m=5, pgtol=1e-4, ftol=1e-6)
    betas_s = (0, 50, 100)
    Z64 = torch.tensor(draws, dtype=torch.float64, device=dev)
    err_k2 = 0.0
    for beta in betas_s:
        rf = rung_rf(rf0, MAIN["alpha"], beta, torch.float64)
        rk = solve.solve_kernel(Z64, rf, c64m, opts_s)
        x3, rec3 = solve.ladder_kernel(
            Z64, torch.tensor([rf], dtype=torch.float64, device=dev), c64m,
            opts_s)
        torch.cuda.synchronize()
        rp = solve.solve_reference(Z64, rf, c64m, opts_s)
        scale = torch.amax(torch.abs(rp.x), dim=1, keepdim=True)
        rel_k2 = float(torch.max(torch.abs(rk.x - rp.x) / scale))
        rel_k3 = float(torch.max(torch.abs(x3 - rp.x) / scale))
        err_k2 = max(err_k2, float(torch.max(torch.abs(rk.x - rp.x))))
        print(f"K2/K3 f64 short solve beta={beta}: niter {rk.niter.tolist()}"
              f" / {rec3['niter'][:, 0].tolist()} / plain "
              f"{rp.niter.tolist()}; nfev {rk.nfev.tolist()} / "
              f"{rec3['nfev'][:, 0].tolist()} / {rp.nfev.tolist()}; status "
              f"{rk.status.tolist()} / {rec3['status'][:, 0].tolist()} / "
              f"{rp.status.tolist()}; x rel err K2 {rel_k2:.3e}, K3 "
              f"{rel_k3:.3e} (bound 1e-8); K3 bit-identical to K2: "
              f"{torch.equal(x3, rk.x)}")
        for nm, got in (("K2", (rk.niter, rk.nfev, rk.status)),
                        ("K3", (rec3["niter"][:, 0], rec3["nfev"][:, 0],
                                rec3["status"][:, 0]))):
            check(all(torch.equal(u, v) for u, v in
                      zip(got, (rp.niter, rp.nfev, rp.status))),
                  f"{nm} f64 counts differ from the plain version at "
                  f"beta={beta}")
        check(rel_k2 <= 1e-8 and rel_k3 <= 1e-8,
              f"K2/K3 f64 x differs from the plain version at beta={beta}")
        rk2 = solve.solve_kernel(Z64, rf, c64m, opts_s)
        check(all(torch.equal(u, v) for u, v in zip(rk, rk2)),
              "K2 repeated launch is not bit-identical")

    # phase 4's f64 ladder, 4 members: K3, K2 through the hook, plain
    opts_t = LBFGSOptions(m=5, maxiter=3000, maxls=20, pgtol=1e-8, ftol=0.0)
    rng = np.random.default_rng(1)
    xp4 = torch.tensor(np.stack([
        pack(spec, tw["traj"] + 0.3 * rng.normal(size=tw["traj"].shape),
             np.array([tw["F"] + 0.5 * rng.normal()]))
        for _ in range(MAIN["B"])]), device=dev)
    rfs10 = np.array([rung_rf(float(tw["RM"]), MAIN["alpha"], b,
                              torch.float64) for b in range(10)])
    lad10 = solve.make_ladder_solver(spec, opts_t, 10, device=dev)
    x_k3, r_k3 = lad10(xp4, rfs10)
    torch.cuda.synchronize()
    x_k3b, r_k3b = lad10(xp4, rfs10)
    torch.cuda.synchronize()
    check(torch.equal(x_k3, x_k3b)
          and all(torch.equal(r_k3[k], r_k3b[k]) for k in r_k3),
          "K3 repeated launch is not bit-identical")
    hook = make_ensemble_ladder(
        act64k, parts64, np.arange(10), float(tw["RM"]), MAIN["alpha"],
        opts=opts_t, rung_solver=solve.make_rung_solver(spec, opts_t,
                                                        device=dev),
        device=dev)(xp4)
    t_pl = time.perf_counter()
    x_pl, r_pl = solve.ladder_reference(xp4, rfs10, c64m, opts_t)
    torch.cuda.synchronize()
    print(f"f64 plain ladder (10 rungs, 4 members): "
          f"{time.perf_counter() - t_pl:.2f} s")
    ok_pl = r_pl["status"].cpu().numpy() <= 1
    A_pl = r_pl["A"].cpu().numpy()
    err_k3 = 0.0
    for nm, A_x, st_x in (("K3", r_k3["A"], r_k3["status"]),
                          ("K2 via the hook", hook.A, hook.status)):
        both = ok_pl & (st_x.cpu().numpy() <= 1)
        d = np.abs(A_x.cpu().numpy() - A_pl)
        rel = d / np.abs(A_pl)
        if nm == "K3":
            err_k3 = float(d[both].max())
        print(f"f64 10-rung ladder {nm} vs plain: mutually converged rungs "
              f"{int(both.sum())}/{both.size}; max rel A difference "
              f"{rel[both].max():.3e} (bound 1e-8)")
        check(both.mean() >= 0.8, f"{nm}: too few converged rungs")
        check(np.all(rel[both] <= 1e-8),
              f"f64 ladder through {nm} disagrees: {rel}")
    phase("7 K2/K3 vs plain f64", t0)

    # ---- 8. K2 and K3 vs plain in f32; their times on these solves -------
    t0 = time.perf_counter()
    # Witness: the plain version on the CPU, the same arithmetic summed in
    # another order. At the top rungs the action is f32 round-off, and two
    # correct f32 solves part there after a few iterations; the kernels'
    # f may differ from the plain version's by up to twice what the plain
    # version differs from itself across summation orders, and never by
    # less than 1e-4 is asked. Counts and statuses must be identical.
    c32_cpu = ag.ag_consts(spec, "cpu", torch.float32)
    rfs_s = [rung_rf(np.float32(rf0), MAIN["alpha"], b, torch.float32)
             for b in betas_s]
    ms_k2, ms_p2, work_k2 = [], [], [0, 0]
    for beta, rf in zip(betas_s, rfs_s):
        rk = solve.solve_kernel(Z32, rf, c32, opts_s)
        x3, rec3 = solve.ladder_kernel(
            Z32, torch.tensor([rf], device=dev), c32, opts_s)
        torch.cuda.synchronize()
        t_p = time.perf_counter()
        rp = solve.solve_reference(Z32, rf, c32, opts_s)
        torch.cuda.synchronize()
        ms_p2.append((time.perf_counter() - t_p) * 1e3)
        rc = solve.solve_reference(Z32.cpu(), rf, c32_cpu, opts_s)
        wit = float(torch.max(torch.abs(rp.f.cpu() - rc.f) / torch.abs(rc.f)))
        f_bound = max(1e-4, 2.0 * wit)
        check(all(torch.equal(u.cpu(), v) for u, v in
                  zip((rp.niter, rp.nfev, rp.status),
                      (rc.niter, rc.nfev, rc.status))),
              f"f32 plain solve on the card and on the CPU differ in counts "
              f"at beta={beta}")
        ms_k2.append(events_ms(lambda: solve.solve_kernel(Z32, rf, c32,
                                                          opts_s), n=5))
        work_k2[0] += int(rk.nfev.sum())
        work_k2[1] += int(rk.niter.sum())
        for nm, f_x, cnt in (("K2", rk.f, (rk.niter, rk.nfev, rk.status)),
                             ("K3", rec3["A"][:, 0],
                              (rec3["niter"][:, 0], rec3["nfev"][:, 0],
                               rec3["status"][:, 0]))):
            rel = float(torch.max(torch.abs(f_x - rp.f) / torch.abs(rp.f)))
            print(f"{nm} f32 short solve beta={beta}: f rel err {rel:.3e}, "
                  f"plain on the card vs on the CPU {wit:.3e} (bound "
                  f"{f_bound:.3e}); niter {cnt[0].tolist()} / plain "
                  f"{rp.niter.tolist()}; nfev {cnt[1].tolist()} / "
                  f"{rp.nfev.tolist()}; status {cnt[2].tolist()} / "
                  f"{rp.status.tolist()}")
            check(rel <= f_bound and all(
                torch.equal(u, v) for u, v in
                zip(cnt, (rp.niter, rp.nfev, rp.status))),
                f"{nm} f32 disagrees with its plain version at beta={beta}")
    ms_k2 = float(np.mean(ms_k2))
    ms_p2 = float(np.mean(ms_p2))
    rfs3 = torch.tensor(rfs_s, device=dev)
    _, rec3 = solve.ladder_kernel(Z32, rfs3, c32, opts_s)
    ms_k3 = events_ms(lambda: solve.ladder_kernel(Z32, rfs3, c32, opts_s),
                      n=5)
    t_p = time.perf_counter()
    solve.ladder_reference(Z32, rfs_s, c32, opts_s)
    torch.cuda.synchronize()
    ms_p3 = (time.perf_counter() - t_p) * 1e3
    bound_k2 = solve_bound(spec, torch.float32, MAIN["B"], len(betas_s),
                           work_k2[0], work_k2[1], opts_s.m, rungs=1)
    bound_k3 = solve_bound(spec, torch.float32, MAIN["B"], 1,
                           int(rec3["nfev"].sum()), int(rec3["niter"].sum()),
                           opts_s.m, rungs=len(betas_s))
    print(f"K2 f32 (B=4, maxiter 30, one rung a launch): {ms_k2:.4f} ms a "
          f"launch (CUDA events), plain {ms_p2:.4f} ms; bound "
          f"{bound_k2[0]:.3e} ms ({bound_k2[1]}: {bound_k2[2]} bytes, "
          f"{bound_k2[3]} operations per launch)")
    print(f"K3 f32 (B=4, the 3 rungs warm-started in one launch): "
          f"{ms_k3:.4f} ms a launch, plain {ms_p3:.4f} ms; bound "
          f"{bound_k3[0]:.3e} ms ({bound_k3[1]}: {bound_k3[2]} bytes, "
          f"{bound_k3[3]} operations)")
    phase("8 K2/K3 vs plain f32 and times", t0)

    # ---- 9. the new path: the port's bench, K3 then K2 ----------------------
    t0 = time.perf_counter()
    # one K3 ladder call of the new path, timed and profiled in a child
    # process (see profile_k3)
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--profile-k3"], capture_output=True, text=True,
                           timeout=600, cwd=ROOT)
    check(child.returncode == 0, "the K3 profile failed:\n" + child.stdout
          + child.stderr)
    pk = json.loads(child.stdout.strip().splitlines()[-1])
    check(pk["k3_us"] > 0, "torch.profiler recorded no K3 device time")
    bound_main = solve_bound(spec, torch.float32, MAIN["B"], 1,
                             int(sum(pk["nfev"])), int(sum(pk["niter"])), 5,
                             rungs=MAIN["n_beta"])
    print(f"K3 main path (f32, {MAIN['n_beta']} rungs, B={MAIN['B']}, in a "
          f"child process): {pk['ms']:.3f} ms a launch (CUDA events); "
          f"profiled call wall {pk['wall_us'] / 1e3:.3f} ms, device busy "
          f"{pk['busy_us'] / 1e3:.3f} ms "
          f"({100 * pk['busy_us'] / pk['wall_us']:.1f} %), K3 device time "
          f"{pk['k3_us'] / 1e3:.3f} ms; nfev per member {pk['nfev']}, "
          f"niter per member {pk['niter']}; bound {bound_main[0]:.3e} ms "
          f"({bound_main[1]}: {bound_main[2]} bytes, {bound_main[3]} "
          f"operations)")
    from varanneal_tpu_torch import bench
    paths = {}
    for solver_name, want in (("ladder", dict(ladder=1, rung=0)),
                              ("fused", dict(ladder=0,
                                             rung=MAIN["n_beta"]))):
        ag.LAUNCHES = 0
        solve.LADDER_LAUNCHES = 0
        solve.RUNG_LAUNCHES = 0
        buf_out, buf_err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf_out), \
                contextlib.redirect_stderr(buf_err):
            run = bench.main(device=dev, env=dict(
                BENCH_SOLVER=solver_name, BENCH_NINIT=str(MAIN["B"])))
        counts = dict(ag=ag.LAUNCHES, ladder=solve.LADDER_LAUNCHES,
                      rung=solve.RUNG_LAUNCHES)
        print(f"bench {solver_name}: " + buf_out.getvalue().strip())
        print(f"bench {solver_name}: " + buf_err.getvalue().strip())
        A_t = run.tail.A.cpu().numpy()
        fa0 = float(A_t[0, -1])
        rel = abs(fa0 - JAX_FINAL_A_TAIL64) / JAX_FINAL_A_TAIL64
        stat = np.bincount(run.res.status.cpu().numpy().ravel(), minlength=4)
        print(f"new path {solver_name}: timed f32 ladder call "
              f"{run.wall:.4f} s for {MAIN['B']} members; total nfev "
              f"{run.total_nfev}; statuses per code 0..3 {stat.tolist()}; "
              f"launches in the {run.calls} ladder calls: "
              f"{run.launches}, after the tail: {counts}; final_A_tail64 "
              f"member 0 {fa0:.6f} vs JAX {JAX_FINAL_A_TAIL64:.6f} (rel "
              f"{rel:.3e}, bound 1e-2); members "
              + ", ".join(f"{a:.6f}" for a in A_t[:, -1]))
        check(run.launches["ladder"] == want["ladder"] * run.calls
              and run.launches["rung"] == want["rung"] * run.calls
              and run.launches["ag"] == 0,
              f"bench {solver_name} did not run through its kernel alone: "
              f"{run.launches}")
        check(tuple(run.res.A.shape) == (MAIN["B"], MAIN["n_beta"]),
              f"bench {solver_name}: record shape {tuple(run.res.A.shape)}")
        for nm in ("A", "nfev", "status"):
            check(bool(torch.isfinite(getattr(run.res, nm).double()).all()),
                  f"bench {solver_name}: non-finite {nm}")
        check(bool(torch.isfinite(run.res.XP).all())
              and bool(np.isfinite(A_t).all()),
              f"bench {solver_name}: non-finite XP or tail")
        check(rel <= 1e-2, f"bench {solver_name}: final_A_tail64 {fa0} vs "
              f"{JAX_FINAL_A_TAIL64}")
        paths[solver_name] = (run, counts)

    phase("9 new path (bench ladder, fused) and profile", t0)
    print(f"total: {time.perf_counter() - t_all:.2f} s")

    line = dict(route="cuda", library_ms=None)
    src_solve = "varanneal_tpu_torch/kernels/csrc/solve_kernel.cu"
    print(json.dumps({"kernels": [dict(
        name="l96_ag_trap",
        source="varanneal_tpu_torch/kernels/csrc/ag_kernel.cu",
        replaces="varanneal_tpu/kernels/ag_pallas.py:279",
        launches=launches, max_abs_err=max_abs, ms=ms_kernel,
        plain_ms=ms_plain, bound_ms=bound_ms, bound_by=bound_by, **line),
        dict(name="l96_solve", source=src_solve,
             replaces="varanneal_tpu/kernels/solve_pallas.py:676",
             launches=paths["fused"][1]["rung"], max_abs_err=err_k2,
             ms=ms_k2, plain_ms=ms_p2, bound_ms=bound_k2[0],
             bound_by=bound_k2[1], **line),
        dict(name="l96_ladder", source=src_solve,
             replaces="varanneal_tpu/kernels/solve_pallas.py:951",
             launches=paths["ladder"][1]["ladder"], max_abs_err=err_k3,
             ms=ms_k3, plain_ms=ms_p3, bound_ms=bound_k3[0],
             bound_by=bound_k3[1], main_ms=pk["ms"],
             main_bound_ms=bound_main[0], **line)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile-k3"]:
        sys.path.insert(0, ROOT)
        sys.exit(profile_k3())
    sys.exit(main())
