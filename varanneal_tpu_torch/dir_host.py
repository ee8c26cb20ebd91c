"""Host time of a call of K7a's and K7b's wrappers and of their pieces,
this checkout against another's, on one card, in turns.

    python3 -m varanneal_tpu_torch.dir_host [OTHER_CHECKOUT]

``OTHER_CHECKOUT`` is the root of another checkout of the repo, e.g. the
parent commit unpacked by ``git archive`` into the git-ignored
``scratch_archive/``. Each turn is a child process that imports one
checkout's ``varanneal_tpu_torch`` and calls its wrappers at the main
path's shape (B=4, n=3,221, m=5, a full history, every pair taken), so
the two checkouts' launch interfaces may differ. The turns run other,
this, this, other (this alone without ``OTHER_CHECKOUT``). A turn prints
one line of microseconds a call, each the least of three runs of 3,000
calls timed on the host's clock with the card left to catch up after
each run:

- ``k7b`` and ``k7a``: ``dir.fused_step_kernel`` and
  ``dir.compact_dir_kernel`` as the fused loop and the facade call them;
- ``flags``, ``alloc``, ``check`` and ``stream``: the wrapper's pieces
  before the launch (K7b's (B, 2) flags from two (B,) bool tensors on the
  card, d's and sc's allocation, the argument checks, the device's
  current stream);
- ``lib_step`` and ``lib_dir``: the library's launch function alone with
  prepared pointers; in a checkout with ``dir.cluster_plan``, at one
  block a member (``_c1``) and at the plan's cluster (``_cN``), and
  ``plan``, the cached plan lookup.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_us(fn, calls=3000, warm=50):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def turn():
    """One checkout's line (this process imports the package on sys.path)."""
    import numpy as np
    import torch
    from varanneal_tpu_torch.kernels import dir as kdir
    dev = torch.device("cuda")
    B, n, m = 4, 3221, 5
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    H = f32(rng.normal(size=(B, 2 * m, n)))
    hd = torch.full((B,), 2, dtype=torch.int32, device=dev)
    hl = torch.full((B,), m, dtype=torch.int32, device=dev)
    g, xo = f32(rng.normal(size=(B, n))), f32(rng.normal(size=(B, n)))
    xn = xo + 0.1 * f32(rng.normal(size=(B, n)))
    gn = g + 0.1 * f32(rng.normal(size=(B, n)))
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    out = {}
    out["k7b"] = _host_us(lambda: kdir.fused_step_kernel(
        H, xo, xn, g, gn, hd, hl, ones, ones))
    out["k7a"] = _host_us(lambda: kdir.compact_dir_kernel(g, H, hd, hl))

    def flags():
        return torch.stack([torch.as_tensor(ones), torch.as_tensor(ones)],
                           dim=1).to(device=dev, dtype=torch.int32)
    out["flags"] = _host_us(flags)
    out["alloc"] = _host_us(lambda: (
        torch.empty_like(gn),
        torch.empty(B, 7, dtype=torch.float32, device=dev)))
    out["check"] = _host_us(lambda: kdir._check(H, (xo, xn, g, gn),
                                                (hd, hl)))

    def stream():
        with torch.cuda.device(H.device):
            return torch.cuda.current_stream(H.device).cuda_stream
    out["stream"] = _host_us(stream)
    lib = kdir._lib()
    fl = flags()
    d = torch.empty_like(gn)
    sc = torch.empty(B, 7, dtype=torch.float32, device=dev)
    s = stream()
    step_ptrs = [t.data_ptr() for t in (H, xo, xn, g, gn, hd, hl, fl)]
    dir_ptrs = [t.data_ptr() for t in (g, H, hd, hl)]
    if hasattr(kdir, "cluster_plan"):
        out["plan"] = _host_us(lambda: kdir.launch_plan(H, step=True))
        for c in (1, kdir.launch_plan(H, step=True).size):
            pb, pa = kdir.plan_of(n, m, c, True), kdir.plan_of(n, m, c, False)
            out[f"lib_step_c{c}"] = _host_us(lambda: lib.va_fused_step_f32(
                *step_ptrs, B, m, n, pb.size, pb.width, pb.rows,
                d.data_ptr(), sc.data_ptr(), s))
            out[f"lib_dir_c{c}"] = _host_us(lambda: lib.va_compact_dir_f32(
                *dir_ptrs, B, m, n, pa.size, pa.width, pa.rows,
                d.data_ptr(), s))
    else:
        out["lib_step"] = _host_us(lambda: lib.va_fused_step_f32(
            *step_ptrs, B, m, n, d.data_ptr(), sc.data_ptr(), s))
        out["lib_dir"] = _host_us(lambda: lib.va_compact_dir_f32(
            *dir_ptrs, B, m, n, d.data_ptr(), s))
    return out


_TURN = ("import runpy, sys; "
         "sys.exit(runpy.run_path(sys.argv[1])['main'](['--turn']))")


def main(argv):
    if argv[:1] == ["--turn"]:
        print(" ".join(f"{k}={v:.2f}" for k, v in turn().items()))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    other = os.path.abspath(argv[0]) if argv else None
    order = [(other, "other"), (ROOT, "this"), (ROOT, "this"),
             (other, "other")] if other else [(ROOT, "this")]
    rc = 0
    for root, label in order:
        env = dict(os.environ, PYTHONPATH=root)
        # this file's turn() in a child whose sys.path starts at root
        r = subprocess.run([sys.executable, "-c", _TURN,
                            os.path.abspath(__file__)],
                           env=env, cwd=root, capture_output=True, text=True)
        line = r.stdout.strip().splitlines()[-1:] or [r.stderr[-2000:]]
        print(f"{label} (us a call): {line[0]}", flush=True)
        rc |= r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
