"""Profiling utilities: torch.profiler traces and wall-clock timing
(counterpart of interiorpoint_tpu/utils/profiling.py, which traces with
jax.profiler).

``trace_solve`` records one solve with ``torch.profiler`` (host
activity, and the GPU's kernels when CUDA is available) and exports it as
a Chrome trace, viewable in Perfetto or chrome://tracing; ``time_solve``
reports steady-state wall-clock statistics of ``solve()``, each
repetition ending in ``torch.cuda.synchronize()`` when the solver lives
on the GPU.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

TRACE_FILE = "trace.json"


def _on_gpu(solver) -> bool:
    dev = getattr(solver, "device", None)
    return dev is not None and torch.device(dev).type == "cuda"


@contextlib.contextmanager
def device_trace(logdir="ipx_trace"):
    """Record a torch.profiler trace around a block of work and export
    it to ``logdir``/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def trace_solve(solver, logdir="ipx_trace", **solve_kwargs):
    """Profile one solve after a warm-up solve; returns (value,
    logdir), the trace in ``logdir``/trace.json."""
    solver.solve(**solve_kwargs)
    with device_trace(logdir):
        value = solver.solve(**solve_kwargs)
    return value, logdir


def time_solve(solver, reps=3, warmup=1, **solve_kwargs):
    """Steady-state timing of ``solver.solve()``; returns a stats dict."""
    sync = torch.cuda.synchronize if _on_gpu(solver) else (lambda: None)
    for _ in range(warmup):
        solver.solve(**solve_kwargs)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.time()
        solver.solve(**solve_kwargs)
        sync()
        times.append(time.time() - t0)
    return {
        "mean_s": float(np.mean(times)),
        "min_s": float(np.min(times)),
        "max_s": float(np.max(times)),
        "times": times,
    }
