"""Benchmark of the port: the full precision-annealing ladder on the
canonical config (Lorenz-96 D=20, L=8 observed, trapezoid, N=161,
β=0..100: BASELINE.md config #1), on the CUDA card.

    python3 -m varanneal_tpu_torch.bench

The port of ``bench.py``'s ``main()``. It prints ONE JSON line with
bench.py's keys: {"metric", "value", "unit", "vs_baseline", "platform",
"final_A_tail64"}. ``value`` is the wall time of one timed ladder call
per initial path, ending in ``torch.cuda.synchronize()``, after one warm
call (which includes the kernels' nvcc build); ``vs_baseline`` is the
north-star target (1 s per init) over it. ``final_A_tail64`` is the mean
over members of the final action after a K-rung f64 tail from the f32
ladder's endpoint, one rung per call as bench.py runs it, outside the
timed section, on the generic compact L-BFGS loop over K1's f64 kernel.
A line on stderr gives total_nfev and the card's name and power limit.

Env knobs, as bench.py's where the port has the path:

- ``BENCH_SOLVER=ladder|fused|xla`` (default ``ladder``): ``ladder`` runs
  all rungs in one launch of K3 per call (``kernels.solve.
  make_ladder_solver``); ``fused`` one launch of K2 per rung through the
  ladder's ``rung_solver`` hook; ``xla`` the generic batched L-BFGS loop
  over the action of ``BENCH_ENGINE``;
- ``BENCH_ENGINE=auto|ag|xla|pallas`` (``ag``: K1; ``xla``: the autograd
  action; ``pallas`` or ``BENCH_PALLAS=1``: the time-blocked FE kernels
  K6, trapezoid forward and backward with a scalar rf, through
  ``kernels.fe.select_action(engine='pallas')``; ``auto``: that
  function's policy, the autograd action at D=20),
  ``BENCH_DTYPE=f32|f64``, ``BENCH_NINIT`` (default 1),
  ``BENCH_NBETA`` (101), ``BENCH_MAXITER`` (500), ``BENCH_DIRECTION``
  (auto), ``BENCH_M`` (5), ``BENCH_MAXLS`` (20), ``BENCH_TAIL64`` (20);
- ``BENCH_PACK=k``: as in bench.py, k > 1 with ``BENCH_NINIT > 1`` takes
  the packed-member kernel K8 (``kernels.solve_pack.
  make_packed_rung_solver``, one launch a rung) under ``fused``/``ladder``
  where ``solve_pack.pack_supported`` holds, else prints bench.py's note
  ``# BENCH_PACK unsupported here; k=1 fused`` on stderr and takes K2;
  with one init a ``ladder`` run goes through K2 per rung instead of K3.

- ``BENCH_INNER=lbfgs|lm``: as in bench.py, ``lm`` under ``xla`` runs
  the ladder's inner solve on the matrix-free Levenberg–Marquardt solver
  (``opt.lm``, ``maxiter // 10`` iterations a rung over
  ``opt.lm.make_residual_fn``, the engine's action for the records);
  under ``ladder`` and ``fused`` bench.py ignores it, and so does the
  port.

The engine is read where the action is evaluated: every evaluation
under ``xla``, and the per-rung records under ``fused`` (and ``ladder``
when it runs per rung); K3 under ``ladder`` evaluates in its own launch.
bench.py's CPU fallback has no counterpart: without a card the run fails and exits
non-zero. ``main(device="cpu")`` runs the plain versions on the CPU, for
tests.
"""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from varanneal_tpu_torch._device import resolve_device
from varanneal_tpu_torch.anneal import run_ladder
from varanneal_tpu_torch.anneal.ladder import rung_rf
from varanneal_tpu_torch.kernels import ag, fe, solve, solve_pack
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.opt.lm import LMOptions, make_residual_fn
from varanneal_tpu_torch.parallel import (make_ensemble_ladder,
                                          random_ensemble_inits)
from varanneal_tpu_torch.twin import lorenz96_twin

ALPHA = 1.5


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def main(device=None, env=None):
    """Run the benchmark and print its JSON line. ``device=None`` means the
    CUDA card; ``env`` (default ``os.environ``) holds the knobs. Returns
    the run's details: the JSON record, the timed call's ladder result,
    the tail's, the wall time, total nfev and the launch counts of the
    (two) ladder calls, the tail's launches left out."""
    env = os.environ if env is None else env
    device = resolve_device(device)
    dtype_s = env.get("BENCH_DTYPE", "f32")
    if dtype_s == "f64":
        dtype, np_dt = torch.float64, np.float64
        ftol, pgtol = 2.22e-9, 1e-8
    elif dtype_s == "f32":
        dtype, np_dt = torch.float32, np.float32
        ftol, pgtol = 1e-6, 1e-4
    else:
        raise ValueError(f"BENCH_DTYPE must be f32 or f64, got {dtype_s!r}")
    n_init = int(env.get("BENCH_NINIT", "1"))
    n_beta = int(env.get("BENCH_NBETA", "101"))
    maxiter = int(env.get("BENCH_MAXITER", "500"))
    engine = env.get("BENCH_ENGINE", "auto")
    if env.get("BENCH_PALLAS") == "1":
        engine = "pallas"
    bench_solver = env.get("BENCH_SOLVER", "ladder")
    if engine not in ("auto", "ag", "xla", "pallas"):
        raise ValueError(f"unknown BENCH_ENGINE {engine!r}")
    if bench_solver not in ("ladder", "fused", "xla"):
        raise ValueError(f"unknown BENCH_SOLVER {bench_solver!r}")
    pack = int(env.get("BENCH_PACK", "1"))
    if bench_solver == "ladder" and pack > 1:
        bench_solver = "fused"     # bench.py: K2 per rung, not K3

    tw = lorenz96_twin(D=20, N_data=161, n_obs=8)
    spec = build_spec(lorenz96, 20, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                      disc="trapezoid", P=np.array([4.0]), pidx=[0])
    betas = np.arange(n_beta)
    rf0 = np_dt(4e-6 * tw["RM"])
    direction = env.get("BENCH_DIRECTION", "auto")
    opts = LBFGSOptions(maxiter=maxiter, pgtol=pgtol, ftol=ftol,
                        direction=direction,
                        m=int(env.get("BENCH_M", "5")),
                        maxls=int(env.get("BENCH_MAXLS", "20")))
    pack_solver = None
    if bench_solver == "fused" and pack > 1 and n_init > 1:
        if solve_pack.pack_supported(spec, float(rf0), opts, pack,
                                     dtype=dtype, device=device):
            pack_solver = solve_pack.make_packed_rung_solver(
                spec, opts, pack, device=device)
        else:
            print("# BENCH_PACK unsupported here; k=1 fused",
                  file=sys.stderr)

    if bench_solver == "ladder":
        if not solve.ladder_supported(spec, float(rf0), opts, dtype=dtype,
                                      n_rungs=n_beta):
            raise ValueError("BENCH_SOLVER=ladder: the problem is outside "
                             "the ladder kernel's envelope")
        lad = solve.make_ladder_solver(spec, opts, n_beta, device=device)
        rfs = np.array([rung_rf(rf0, ALPHA, b, dtype) for b in betas])

        def fn(xp):
            xpo, recs = lad(xp, rfs)
            return SimpleNamespace(XP=xpo, **recs)
    else:
        action, parts = fe.select_action(spec, float(rf0), engine=engine,
                                      dtype=dtype, device=device)
        kw = {}
        if bench_solver == "xla" and env.get("BENCH_INNER",
                                             "lbfgs") == "lm":
            kw = dict(inner="lm",
                      residual_fn=make_residual_fn(spec, device),
                      lm_opts=LMOptions(maxiter=maxiter // 10, ftol=ftol,
                                        pgtol=pgtol))
        elif pack_solver is not None:
            kw = dict(rung_solver=pack_solver)
        elif bench_solver == "fused":
            if not solve.solve_supported(spec, float(rf0), opts,
                                         dtype=dtype):
                raise ValueError("BENCH_SOLVER=fused: the problem is "
                                 "outside the rung-solve kernel's envelope")
            kw = dict(rung_solver=solve.make_rung_solver(spec, opts,
                                                         device=device))
        fn = make_ensemble_ladder(action, parts, betas, rf0, ALPHA,
                                  opts=opts, store_paths=False,
                                  device=device, **kw)

    xp0 = torch.tensor(random_ensemble_inits(spec, n_init, seed=3,
                                             dtype=np_dt), device=device)

    tail64 = int(env.get("BENCH_TAIL64", "20"))
    tail_fn = None
    if tail64 > 0 and dtype == torch.float32:
        act64, parts64 = ag.make_action_ag(spec, device=device,
                                           dtype=torch.float64)
        opts64 = LBFGSOptions(maxiter=4 * maxiter, pgtol=1e-8,
                              ftol=2.22e-9, direction=direction)
        tail_betas = np.arange(n_beta - tail64, n_beta)

        def tail_fn(xp):
            xp = xp.double()
            for b in tail_betas:       # one rung per call, as bench.py
                r = run_ladder(act64, parts64, xp, np.array([b]),
                               np.float64(rf0), ALPHA, opts=opts64,
                               store_paths=False, device=device)
                xp = r.XP
            return r

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    launches = dict(ag=0, rung=0, ladder=0, pack=0, fe_fwd=0, fe_vag=0)

    def counts():
        return dict(ag=ag.LAUNCHES, rung=solve.RUNG_LAUNCHES,
                    ladder=solve.LADDER_LAUNCHES,
                    pack=solve_pack.PACK_LAUNCHES,
                    fe_fwd=fe.FWD_LAUNCHES + fe.SH_FWD_LAUNCHES,
                    fe_vag=fe.ONESTEP_VAG_LAUNCHES + fe.SH_VAG_LAUNCHES)

    def ladder_call():
        before = counts()
        r = fn(xp0)
        sync()
        for k, n in counts().items():
            launches[k] += n - before[k]
        return r

    ladder_call()                       # warm: builds and loads the kernels
    t0 = time.perf_counter()
    res = ladder_call()
    wall = time.perf_counter() - t0

    per_init = wall / n_init
    nfev = int(res.nfev.sum())
    tail = tail_fn(res.XP) if tail_fn is not None else None
    final_a_tail64 = (float(tail.A[:, -1].mean()) if tail is not None
                      else None)
    out = {
        "metric": "lorenz96_d20_full_ladder_wall_s_per_init",
        "value": round(per_init, 6),
        "unit": "s/init",
        "vs_baseline": round(1.0 / per_init, 4),
        "platform": "gpu" if device.type == "cuda" else "cpu",
    }
    if final_a_tail64 is not None:
        out["final_A_tail64"] = round(final_a_tail64, 6)
    print(json.dumps(out), flush=True)
    card = card_line() if device.type == "cuda" else "no card (CPU run)"
    print(f"# device={card} solver={bench_solver} dtype={dtype_s} "
          f"n_init={n_init} n_beta={n_beta} maxiter={maxiter} "
          f"total_nfev={nfev} action+grad_evals/s={nfev / wall:,.0f}"
          + (f" final_A_tail64={final_a_tail64:.6g}"
             if final_a_tail64 is not None else ""),
          file=sys.stderr, flush=True)
    return SimpleNamespace(out=out, res=res, tail=tail, wall=wall,
                           total_nfev=nfev, launches=launches, calls=2)


if __name__ == "__main__":
    main()
