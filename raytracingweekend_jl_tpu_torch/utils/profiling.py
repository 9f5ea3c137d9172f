"""Profiling helpers — the structured replacement for the reference's manual
BenchmarkTools sprinkling and comment history (SURVEY.md §5).

The JAX package's ``compile_stats`` (an XLA lowering's compile time and
memory) has no counterpart here: the port lowers nothing through XLA, and
its kernels are built once by ``ops/cuda/build.py`` and cached.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (the host and, where CUDA is
    available, the card) and write it as a Chrome trace
    ``<log_dir>/trace.json`` when the block ends. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed(fn, *args, sync: bool = True, **kwargs):
    """``(result, wall_s)`` of ``fn(*args, **kwargs)``. With ``sync``, when
    the result (or the first tensor of a tuple or list result) is a CUDA
    tensor, the clock stops after ``torch.cuda.synchronize`` of its device:
    PyTorch returns before the card has finished."""
    t0 = time.time()
    out = fn(*args, **kwargs)
    if sync:
        first = out
        if isinstance(out, (tuple, list)) and out:
            first = out[0]
        if isinstance(first, torch.Tensor) and first.is_cuda:
            torch.cuda.synchronize(first.device)
    return out, time.time() - t0
