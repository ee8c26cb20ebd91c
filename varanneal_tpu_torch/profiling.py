"""Tracing and profiling hooks of the port.

Counterpart of ``varanneal_tpu/profiling.py`` on ``torch.profiler``:
``trace(logdir)`` records everything run inside the block (host
activity, and the CUDA card's kernels when a card is present) and writes
a Chrome-trace JSON file under ``logdir``; ``annotate(name)`` names a
region on that timeline; ``ladder_stats(result)`` summarizes a ladder's
records into the reference's scalar record.

Usage::

    from varanneal_tpu_torch import profiling
    with profiling.trace("va_trace"):
        res = ladder(xp0)
        torch.cuda.synchronize()
    # then open va_trace/trace_*.json in chrome://tracing or Perfetto

    with profiling.annotate("ladder-beta-chunk"):
        ...
"""

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Record the block with torch.profiler (CPU activity, and CUDA
    activity when a card is present) and write the trace to
    ``logdir/trace_<pid>_<ns>.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region on the profiler's timeline (a host-side annotation)."""
    return torch.profiler.record_function(name)


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def ladder_stats(result) -> dict:
    """Summarize a ladder's records (``anneal.ladder.LadderResult``, one
    member or a batch) into the reference's observability record: the
    per-β A/ME/FE/exit and the iteration and evaluation counts."""
    nfev = _np(result.nfev)
    niter = _np(result.niter)
    status = _np(result.status)
    return {
        "n_beta": int(np.shape(nfev)[-1]),
        "total_nfev": int(nfev.sum()),
        "total_niter": int(niter.sum()),
        "final_A": _np(result.A)[..., -1],
        "n_converged": int(np.sum(status <= 1)),
        "n_maxiter": int(np.sum(status == 2)),
        "n_ls_fail": int(np.sum(status == 3)),
    }
