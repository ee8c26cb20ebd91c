"""Thin CLI runner: ``python -m varanneal_tpu_torch CONFIG.json [--f32]
[--device DEVICE]``.

The counterpart of ``python -m varanneal_tpu`` (``varanneal_tpu/__main__.py``)
on the port. The JSON config holds the ``AnnealConfig`` fields plus:

  "model":  {"name": one of the port's models ("lorenz96", "lorenz63",
             "nakl", "colpitts"), "D": state dimension};
  "data":   {"file": "...", "stim_file": "...", "nstart": 0, "N": null}
            (``set_data_fromfile`` semantics: column 0 is time);
  "X0":     optional .npy path for the initial path (default: zeros, with
            the observed components set to the data);
  "P0":     list of initial/fixed parameter values;
  "out":    output prefix of ``*_paths.npy``, ``*_params.npy`` and
            ``*_action_errors.dat``.

Without ``--f32`` the run is in float64: torch's default dtype is set to
float64 before anything else (the counterpart of enabling JAX's x64), so
``anneal(dtype=None)`` takes float64. With ``--f32`` it stays float32,
and a compensated action then combines its sums in float32
(``ops.action.combine_dtype``). ``--device`` defaults to the CUDA card
and raises without one; ``--device cpu`` runs the plain PyTorch path.
"""

import argparse
import json
import sys

import numpy as np
import torch

def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m varanneal_tpu_torch")
    ap.add_argument("config", help="JSON config file")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if not args.f32:
        torch.set_default_dtype(torch.float64)

    from varanneal_tpu_torch import models
    from varanneal_tpu_torch.api import Annealer
    from varanneal_tpu_torch.config import AnnealConfig

    with open(args.config) as fh:
        raw = json.load(fh)
    cfg = AnnealConfig.from_json(args.config)

    model_name = raw["model"]["name"]
    D = int(raw["model"]["D"])
    f = getattr(models, model_name)

    ann = Annealer(device=args.device)
    ann.set_model(f, D)
    d = raw["data"]
    ann.set_data_fromfile(d["file"], stim_file=d.get("stim_file"),
                          nstart=int(d.get("nstart", 0)), N=d.get("N"))

    N_data = ann.data.shape[0]
    if "X0" in raw:
        X0 = np.load(raw["X0"])
    else:
        X0 = np.zeros((N_data, D))
    P0 = np.asarray(raw["P0"], dtype=np.float64)

    cfg.run(ann, X0, P0, verbose=True)

    out = raw.get("out", "va")
    ann.save_paths(f"{out}_paths.npy")
    ann.save_params(f"{out}_params.npy")
    ann.save_action_errors(f"{out}_action_errors.dat")
    print(f"[varanneal_tpu_torch] wrote {out}_paths.npy {out}_params.npy "
          f"{out}_action_errors.dat")
    return 0


if __name__ == "__main__":
    sys.exit(main())
