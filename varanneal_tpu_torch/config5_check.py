"""BASELINE config #5 on the card, member by member: K2 against the plain
rung solve, beside chip_smoke.py's phase 26 (which runs the 1024 members
through K2 alone).

    python3 -m varanneal_tpu_torch.config5_check [MEMBERS]

The problem is examples/ensemble_sweep.py's full configuration: Lorenz-96
D=400, N_data=161, 160 observed, trapezoid, F estimated from 4.0, rf0 =
4e-6·RM, α 1.5, m 5, pgtol 1e-4, ftol 1e-6, and the members are the first
MEMBERS (default 16) of random_ensemble_inits(seed=12). Two checks:

- the ladder: 51 rungs in calls of 17 warm-started rungs, maxiter 300,
  f32, once with K2 as the rung solver and once with the plain rung
  solve (``solve.solve_reference``) on the card; each member's final
  action and both runs' total nfev and statuses;
- f64 by iterations: K2 against the plain rung solve in f64 at β 30 from
  the first 8 members (pgtol 1e-8, ftol 0) at maxiter 10, 30, 100 and
  300: the share of members with equal niter, nfev and status, and the
  largest relative distance of x and of f. The two sum in different
  orders, so their iterates part as the iterations grow.

Prints the card's name and power limit, a line a result, and one JSON
object last.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from varanneal_tpu_torch.anneal.ladder import rung_rf
from varanneal_tpu_torch.kernels import ag, fe, solve
from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec
from varanneal_tpu_torch.opt import LBFGSOptions
from varanneal_tpu_torch.parallel import (make_ensemble_ladder,
                                          random_ensemble_inits)
from varanneal_tpu_torch.twin import lorenz96_twin


def main(members=16):
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    tw = lorenz96_twin(D=400, N_data=161, n_obs=160)
    spec = build_spec(lorenz96, 400, tw["Y"], tw["t"], tw["Lidx"],
                      tw["RM"], disc="trapezoid", P=np.array([4.0]),
                      pidx=[0])
    rf0 = np.float32(4e-6 * tw["RM"])
    opts = LBFGSOptions(m=5, maxiter=300, pgtol=1e-4, ftol=1e-6)
    act, parts = fe.select_action(spec, rf0, engine="auto",
                                  dtype=torch.float32, device=dev)
    k2 = solve.pick_rung_solver(spec, rf0, opts, solver="auto",
                                dtype=torch.float32, device=dev)
    c32 = ag.ag_consts(spec, dev, torch.float32)
    inits = random_ensemble_inits(spec, 1024, seed=12)
    out = dict(card=card, members=members, ladder={}, f64={})
    for name, rung in (("K2", k2), ("plain", lambda XP, rf: (
            solve.solve_reference(XP, float(rf), c32, opts)))):
        xp = torch.tensor(inits[:members], dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        recs = []
        for lo in range(0, 51, 17):
            r = make_ensemble_ladder(act, parts, np.arange(lo, lo + 17),
                                     rf0, 1.5, opts=opts, rung_solver=rung,
                                     device=dev)(xp)
            xp = r.XP
            recs.append(r)
        torch.cuda.synchronize()
        A = torch.cat([r.A for r in recs], dim=1)[:, -1].cpu().numpy()
        st = torch.cat([r.status for r in recs], dim=1).cpu().numpy()
        res = dict(wall_s=time.perf_counter() - t0,
                   nfev=int(sum(int(r.nfev.sum()) for r in recs)),
                   statuses=np.bincount(st.ravel(), minlength=4).tolist(),
                   final_A=[round(float(a), 4) for a in A],
                   median=float(np.median(A)))
        out["ladder"][name] = res
        print(f"ladder {name}: {res}")
    c64 = ag.ag_consts(spec, dev, torch.float64)
    xp = torch.tensor(inits[:8], dtype=torch.float64, device=dev)
    rf = rung_rf(np.float64(rf0), 1.5, 30, torch.float64)
    for maxiter in (10, 30, 100, 300):
        o = LBFGSOptions(m=5, maxiter=maxiter, pgtol=1e-8, ftol=0.0)
        k = solve.solve_kernel(xp, rf, c64, o)
        p = solve.solve_reference(xp, rf, c64, o)
        torch.cuda.synchronize()
        res = {n: float((getattr(k, n) == getattr(p, n)).double().mean())
               for n in ("niter", "nfev", "status")}
        res["x_rel_max"] = float(((k.x - p.x).abs().amax(1)
                                  / p.x.abs().amax(1)).max())
        res["f_rel_max"] = float(((k.f - p.f).abs() / p.f.abs()).max())
        out["f64"][maxiter] = res
        print(f"f64 beta 30, maxiter {maxiter}: {res}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2:
        raise SystemExit(__doc__)
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
