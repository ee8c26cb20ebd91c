"""The Colpitts facade ladder of chip_smoke.py phase 30 through the JAX
package on the CPU (its ROW settings: the reference test's alpha 1.5, beta
0..24, RF0 = 1e-4·RM, maxiter 400, gtol 1e-9, eta from 4.0, X0 from
default_rng(4)), on the twin phase 30 runs it on (N_data = ROW['fac_N'],
sigma ROW['fac_sigma']) and on the full-width twin (N_data =
ROW['N_data'], sigma 0.05), so that the port's eta on the card can be
read beside the reference's. Prints each run's eta, exit flags and
iterations per rung.

    JAX_PLATFORMS=cpu python -m tests.colpitts_reference

It takes about fifteen seconds on two CPU cores."""

import time

import jax
import numpy as np

from chip_smoke import ROW
from varanneal_tpu.api import Annealer
from varanneal_tpu.models import COLPITTS_P_TRUE, colpitts
from varanneal_tpu.twin import colpitts_twin


def main():
    jax.config.update("jax_enable_x64", True)
    for N, sigma in ((ROW["fac_N"], ROW["fac_sigma"]), (ROW["N_data"], 0.05)):
        tw = colpitts_twin(N_data=N, sigma=sigma)
        ann = Annealer()
        ann.set_model(colpitts, 3)
        ann.set_data(tw["Y"], t=tw["t"])
        X0 = np.random.default_rng(4).normal(size=(N, 3))
        P0 = np.asarray(COLPITTS_P_TRUE, float).copy()
        P0[3] = ROW["eta0"]
        t0 = time.perf_counter()
        ann.anneal(X0, P0, ROW["alpha"], np.arange(float(ROW["n_beta"])),
                   tw["RM"], ROW["rf0"] * tw["RM"], tw["Lidx"], Pidx=[3],
                   opt_args=dict(maxiter=ROW["maxiter"], gtol=ROW["gtol"]))
        eta = float(np.asarray(ann.minpaths_P)[-1][0])
        off = 100 * abs(eta / COLPITTS_P_TRUE[3] - 1)
        print(f"JAX facade, Colpitts twin N_data={N}, sigma {sigma}: "
              f"{time.perf_counter() - t0:.2f} s; eta {eta:.6f} (truth "
              f"{COLPITTS_P_TRUE[3]}, {off:.2f} % off); exit flags "
              f"{np.asarray(ann.exitflags).tolist()}; "
              f"niter {np.asarray(ann.niter_array).tolist()}")


if __name__ == "__main__":
    main()
