"""BASELINE config #3's staged campaign through the JAX package on the CPU,
at chip_smoke.py phase 27b's cut (its CONF3 and PIDX3): the reference's
``workflow.estimate`` on the same problem, with the autograd action that
``examples/nakl_ensemble.py`` builds, so that the port's result on the card
can be read beside the reference's. Prints the best member, its polished
action and its estimates against the truth and the boxes.

    JAX_PLATFORMS=cpu python -m tests.config3_reference [POLISH_MAXITER]

POLISH_MAXITER defaults to CONF3's. It takes about five minutes on two CPU
cores (B = 64 members at N = 3001 in f32, then four in f64)."""

import sys

import jax
import numpy as np

from chip_smoke import CONF3, PIDX3
from varanneal_tpu import workflow
from varanneal_tpu.api import build_bounds
from varanneal_tpu.models import (NAKL_P_TRUE, NAKL_PNAMES, NAKL_STATE_BOUNDS,
                                  nakl_ensemble_inits, nakl_log_model,
                                  nakl_param_boxes)
from varanneal_tpu.ops import build_spec, make_action
from varanneal_tpu.opt import LBFGSOptions
from varanneal_tpu.twin import nakl_twin


def main(argv):
    jax.config.update("jax_enable_x64", True)
    maxiter = int(argv[0]) if argv else CONF3["polish_maxiter"]
    tw = nakl_twin(N=CONF3["N"], dt=CONF3["dt"], sigma=CONF3["sigma"],
                   seed=CONF3["seed"], seg=75, i_min=-25.0, i_max=60.0)
    pbounds, log_idx = nakl_param_boxes(PIDX3)
    model_f, P_base = nakl_log_model(log_idx)
    bounds = list(NAKL_STATE_BOUNDS) + list(pbounds)
    g = CONF3["gate_rf_scale"]
    rf_dir = np.array([1.0, g, g, g])

    def make_problem(dtype):
        spec = build_spec(model_f, 4, tw["V"].astype(dtype), tw["t"], [0],
                          1.0, disc="SimpsonHermite", P=P_base, pidx=PIDX3,
                          stim=tw["stim"])
        act, parts = make_action(spec)
        lo, hi = build_bounds(spec, bounds, dtype)
        return act, parts, lo, hi, spec

    spec = make_problem(np.float32)[4]
    n = tw["V"].shape[0]
    V = np.interp(np.arange(spec.N_f) * (n - 1) / (spec.N_f - 1),
                  np.arange(n), tw["V"][:, 0])
    xp0 = nakl_ensemble_inits(np.random.default_rng(CONF3["ens_seed"]),
                              CONF3["B"], pbounds, [V], pidx=PIDX3,
                              dtype=np.float32)
    rf0 = np.ascontiguousarray(np.broadcast_to(
        CONF3["rf0"] * rf_dir, (spec.N_f - 1, 4))).astype(np.float32)
    res = workflow.estimate(
        make_problem, xp0, np.arange(CONF3["rungs_b"], dtype=np.float32),
        rf0, CONF3["alpha"], n_params=len(PIDX3),
        opts=LBFGSOptions(maxiter=CONF3["maxiter_b"], m=5, pgtol=1e-4,
                          ftol=1e-6, bounded_algo="projection"),
        snapshot_beta=CONF3["snap_b"], polish_top=CONF3["polish_top"],
        polish_batch=CONF3["polish_top"],
        polish_opts=LBFGSOptions(maxiter=maxiter, pgtol=1e-10, ftol=1e-14,
                                 bounded_algo="projection"),
        polish_extra_betas=CONF3["extra_b"])
    p = res.best[spec.n_state:spec.n_state + len(PIDX3)]
    print(f"reference campaign (JAX, CPU), polish maxiter {maxiter}: best "
          f"member {res.best_member}, polished A {res.best_A:.7g}; "
          "estimates "
          + ", ".join(f"{NAKL_PNAMES[pi]} {p[j]:.4f} (truth "
                      f"{NAKL_P_TRUE[pi]}, box {pbounds[j]})"
                      for j, pi in enumerate(PIDX3)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
