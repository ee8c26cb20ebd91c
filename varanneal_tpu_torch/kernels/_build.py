"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (``extern "C"`` functions that return the launch's
``cudaError_t``). No source includes PyTorch's headers: a plain-C build
takes seconds where ``torch.utils.cpp_extension`` takes minutes, and every
fresh machine builds anew. The libraries go to ``build/varanneal_tpu_torch/``
at the root of the checkout (listed in ``.gitignore``), named by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads the library already there. The build runs at first use, in the
process that needs it. Several sources build in parallel, one nvcc each.
"""

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "varanneal_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    """A loaded kernel library and how it was obtained."""
    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float          # nvcc wall time; 0.0 when loaded from disk
    log: str                # nvcc's stderr (the -Xptxas -v report)


_loaded = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``'s,
    else the one on PATH. Raises when there is none."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Build (or load) the libraries for ``csrc/<name>.cu`` of each name,
    all nvcc processes started together. Returns ``{name: Built}``.
    Raises with nvcc's output when a build fails."""
    out = {n: _loaded[n] for n in names if n in _loaded}
    todo = [n for n in names if n not in out]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        src = CSRC / f"{n}.cu"
        if not src.is_file():
            raise FileNotFoundError(src)
        path = _lib_path(n)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, path, cmd)
    logs = {}
    failed = []
    for n, (p, tmp, path, cmd) in procs.items():
        so, se = p.communicate()
        logs[n] = (so + se).strip()
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n(exit {p.returncode})\n"
                          f"{logs[n]}")
        else:
            os.replace(tmp, path)      # atomic: concurrent loaders agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n\n".join(failed))
    seconds = time.perf_counter() - t0
    for n in todo:
        path = _lib_path(n)
        b = Built(name=n, path=path, lib=ctypes.CDLL(str(path)),
                  seconds=seconds if n in procs else 0.0,
                  log=logs.get(n, ""))
        _loaded[n] = b
        out[n] = b
    return out


def load(name: str) -> Built:
    """The library for ``csrc/<name>.cu``, built at first use."""
    return build([name])[name]
