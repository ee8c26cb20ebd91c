"""Drive the PyTorch/CUDA port (varanneal_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; nothing is installed first. Phases, each
timed on its own line:

1. device: the card's name, count, power limit, the torch and nvcc
   versions; no CUDA device -> exit 1 before any result is printed;
2. build: K1 (kernels/csrc/ag_kernel.cu) with nvcc into a plain-C shared
   library, with nvcc's -Xptxas -v report;
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
   20-rung f64 tail with the autograd action (maxiter 2000, pgtol 1e-8,
   ftol 2.22e-9). The kernel's launch count is zeroed just before and
   read just after: every evaluation of every rung rides one launch, so
   the count must reach, per rung, the most evaluations any member made;
6. K1 against its plain version on the main path's own minimizers (rungs
   0, 60, 100), where the gradient is a small difference of large terms
   and the top rungs' residuals are f32 round-off: A and gradient within
   4x the plain f32 version's own error against f64 on the same inputs
   (the max abs kernel-vs-plain error goes into the kernel line),
   and the first 50 iterations of rung 60 again under torch.profiler:
   device busy share, K1's share of the wall time, the costliest device
   kernels.

The last two lines are one JSON object per kernel (name, route, source,
the TPU kernel it replaces, launches on the main path, max abs error,
times, bound) and the result line {"ok": true, "device": {...}}. Any
failure raises, and the script exits non-zero before that line.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# The card's rates, from NVIDIA's H100 SXM data sheet: HBM bytes/s and
# f32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12}

MAIN = dict(D=20, N_data=161, n_obs=8, B=4, n_beta=101, alpha=1.5,
            tail=20)


def device_us(evt):
    """Self device time of a profiler row in µs, across torch versions."""
    for k in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, k):
            return float(getattr(evt, k))
    return 0.0


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
    from varanneal_tpu_torch.kernels import _build, ag
    from varanneal_tpu_torch.models import lorenz96
    from varanneal_tpu_torch.ops import build_spec, make_action, pack
    from varanneal_tpu_torch.ops import value_and_grad
    from varanneal_tpu_torch.opt import LBFGSOptions, lbfgs_minimize
    from varanneal_tpu_torch.anneal import run_ladder
    from varanneal_tpu_torch.anneal.ladder import rung_rf
    from varanneal_tpu_torch.parallel import (make_ensemble_ladder,
                                              random_ensemble_inits)
    from varanneal_tpu_torch.twin import lorenz96_twin

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
    built = _build.load("ag_kernel")
    print(f"nvcc build of {built.path.name}: {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "Used" in line or "bytes stack frame" in line:
            print("ptxas:", line.strip())
    phase("2 build", t0)

    tw = lorenz96_twin(D=MAIN["D"], N_data=MAIN["N_data"],
                       n_obs=MAIN["n_obs"])
    spec = build_spec(lorenz96, MAIN["D"], tw["Y"], tw["t"], tw["Lidx"],
                      tw["RM"], disc="trapezoid", P=np.array([4.0]),
                      pidx=[0])
    rf0 = 4e-6 * tw["RM"]

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

    def timed(fn, n=1000, warm=20):
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

    ms_kernel = timed(lambda: ag.ag_kernel(Z32, rf_t, c32))
    ms_plain = timed(lambda: ag.ag_reference(Z32, rf_t, c32))
    ms_autograd = timed(lambda: vag32(Z32, rf_t))
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

    t_tail = time.perf_counter()
    act64, parts64a = make_action(spec, device=dev)
    opts64 = LBFGSOptions(maxiter=2000, pgtol=1e-8, ftol=2.22e-9,
                          direction="compact")
    tail = run_ladder(act64, parts64a, res.XP.double(),
                      np.arange(MAIN["n_beta"] - MAIN["tail"],
                                MAIN["n_beta"]), rf0, MAIN["alpha"],
                      opts=opts64, store_paths=False, device=dev)
    torch.cuda.synchronize()
    wall_tail = time.perf_counter() - t_tail
    launches = ag.LAUNCHES

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
          f"BENCH_r05: 16.284792); members: "
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
    print(f"total: {time.perf_counter() - t_all:.2f} s")

    print(json.dumps({"kernels": [{
        "name": "l96_ag_trap",
        "route": "cuda",
        "source": "varanneal_tpu_torch/kernels/csrc/ag_kernel.cu",
        "replaces": "varanneal_tpu/kernels/ag_pallas.py:279",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
