"""The port's config system and runner (varanneal_tpu_torch/config.py,
``python -m varanneal_tpu_torch``) against the JAX package's
(varanneal_tpu/config.py, ``python -m varanneal_tpu``): the config round
trip and its unknown-key check; the runner end to end in a subprocess on
the CPU (``--device cpu``; the JAX runner with JAX_PLATFORMS=cpu), both
in f64, with the same files and shapes and the records of every
converged rung within 1e-8 relative; and, in process on the CPU in f32,
the path the card runs (``compensated: true, engine: "ag"``, a
checkpoint every 2 rungs and a snapshot): the records of a resumed run
equal the uninterrupted run's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from varanneal_tpu.config import AnnealConfig as AnnealConfigJax

from varanneal_tpu_torch import __main__ as runner
from varanneal_tpu_torch.config import AnnealConfig

ROOT = Path(__file__).resolve().parents[1]


def test_anneal_config_roundtrip(tmp_path):
    cfg = dict(alpha=1.5, beta_array={"stop": 5}, RM=4.0, RF0=1e-5,
               Lidx=[0, 1], Pidx=[0], disc="trapezoid",
               opt_args={"maxiter": 30}, compensated=True, repeats=2)
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    c = AnnealConfig.from_json(str(p))
    assert list(c.beta_array) == [0, 1, 2, 3, 4]
    assert c.RM == 4.0 and c.compensated and c.repeats == 2
    assert c == AnnealConfig(**{f: getattr(AnnealConfigJax.from_json(
        str(p)), f) for f in AnnealConfig.__dataclass_fields__})
    # the same fields as the reference's, no more
    assert (list(AnnealConfig.__dataclass_fields__)
            == list(AnnealConfigJax.__dataclass_fields__))
    p.write_text(json.dumps(dict(cfg, nonsense=1)))
    with pytest.raises(ValueError, match="nonsense"):
        AnnealConfig.from_json(str(p))


def _data(tmp_path, N=13):
    rng = np.random.default_rng(0)
    t = 0.025 * np.arange(N)
    Y = rng.normal(size=(N, 2))
    np.save(tmp_path / "data.npy", np.column_stack([t, Y]))
    return t


def test_cli_runner_matches_jax_runner(tmp_path):
    N, D = 13, 5
    t = _data(tmp_path, N)
    files = {}
    for pkg, env_extra in (("varanneal_tpu", dict(JAX_PLATFORMS="cpu")),
                           ("varanneal_tpu_torch", {})):
        cfg = dict(
            model={"name": "lorenz96", "D": D},
            data={"file": str(tmp_path / "data.npy")},
            P0=[8.0], out=str(tmp_path / pkg),
            alpha=1.6, beta_array={"stop": 4}, RM=4.0, RF0=1e-4,
            Lidx=[0, 2], Pidx=[0],
            # every rung solved to pgtol (ftol off): short f64 solves whose
            # iterates the two packages share to round-off
            opt_args={"maxiter": 2000, "gtol": 1e-5, "ftol": 0.0})
        path = tmp_path / f"{pkg}.json"
        path.write_text(json.dumps(cfg))
        cmd = [sys.executable, "-m", pkg, str(path)]
        if pkg == "varanneal_tpu_torch":
            cmd += ["--device", "cpu"]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           env=dict(os.environ, PYTHONPATH=str(ROOT),
                                    **env_extra),
                           cwd=tmp_path, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        files[pkg] = [np.load(tmp_path / f"{pkg}_paths.npy"),
                      np.load(tmp_path / f"{pkg}_params.npy"),
                      np.loadtxt(tmp_path / f"{pkg}_action_errors.dat")]
    (pj, qj, ej), (pt, qt, et) = files["varanneal_tpu"], files[
        "varanneal_tpu_torch"]
    assert pt.shape == pj.shape == (4, N, D + 1)
    assert qt.shape == qj.shape and et.shape == ej.shape == (4, 4)
    np.testing.assert_array_equal(pt[0, :, 0], t)
    np.testing.assert_array_equal(et[:, 0], ej[:, 0])
    assert np.all(np.isfinite(et))
    np.testing.assert_allclose(et[:, 1], ej[:, 1], rtol=1e-8)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(qt, qj, rtol=1e-6)


def test_runner_in_process_compensated_checkpointed(tmp_path):
    """The card's runner path at a small size on the CPU in f32: K4's plain
    version on every evaluation, a checkpoint every 2 rungs and a
    snapshot after rung 3; cutting the checkpoint back to dispatch 4 and
    running again resumes there and gives the same files, bit for bit."""
    N, D = 13, 5
    _data(tmp_path, N)
    np.save(tmp_path / "x0.npy",
            np.random.default_rng(1).normal(2.0, 2.0, (N, D)))
    ck = tmp_path / "ck.npz"
    cfg = dict(
        model={"name": "lorenz96", "D": D},
        data={"file": str(tmp_path / "data.npy")},
        X0=str(tmp_path / "x0.npy"), P0=[8.0], out=str(tmp_path / "run"),
        alpha=1.6, beta_array={"stop": 6}, RM=4.0, RF0=0.5, Lidx=[0, 2],
        Pidx=[0],
        compensated=True, engine="ag", checkpoint_path=str(ck),
        checkpoint_every=2, snapshot_beta=3,
        opt_args={"maxiter": 50, "m": 5})
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert torch.get_default_dtype() == torch.float32
    assert runner.main([str(path), "--f32", "--device", "cpu"]) == 0
    out = [np.load(tmp_path / "run_paths.npy"),
           np.loadtxt(tmp_path / "run_action_errors.dat")]
    assert out[0].shape == (6, N, D + 1) and out[1].shape == (6, 4)
    assert np.all(np.isfinite(out[1]))
    with np.load(ck) as z:
        payload = {k: z[k] for k in z.files}
    assert int(payload["next_idx"]) == 6
    assert payload["A"].dtype == np.float32         # the f32 combine
    assert np.all(payload["nfev"] > 1)
    np.testing.assert_array_equal(payload["snap0"], payload["path0"][2])
    for k in ("A", "ME", "FE", "status", "niter", "nfev", "pgnorm"):
        payload[k] = payload[k][:4]
    payload["path0"] = payload["path0"][:4]
    payload["xp0"] = payload["path0"][3]
    payload["next_idx"] = np.asarray(4)
    np.savez(ck, **payload)
    assert runner.main([str(path), "--f32", "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "run_paths.npy"),
                                  out[0])
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "run_action_errors.dat"), out[1])
