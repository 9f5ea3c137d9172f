"""The traced sub-window: ``torch.profiler`` over a few steady calls, read
back from its Chrome trace into the numbers the per-layer metrics and the
``breakdown`` take.

The trace is written to a temporary file (under ``TMPDIR``), read and
deleted. Everything is measured inside the span of the ``portbench.traced``
range that the harness opens around the traced calls.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

#: Host calls that launch work on the device, one each.
LAUNCH_CALLS = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|"
                          r"cuLaunchKernel|cuLaunchKernelEx|cudaGraphLaunch)"
                          r"(_v\d+)?$")
#: The host syncs ``chip_smoke.py`` counts (its ``SYNC_SUMS``, line 3402):
#: the runtime's stream and device synchronisations, and the device's
#: copies to the host.
SYNC_SUMS = {"stream_sync": r"^cudaStreamSynchronize",
             "device_sync": r"^cudaDeviceSynchronize",
             "memcpy_dtoh": r"^Memcpy DtoH"}
#: Trace categories of work on the device.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Trace categories of host ranges that can label an idle gap.
_HOST_CATS = ("cpu_op", "user_annotation", "python_function",
              "cuda_runtime", "cuda_driver")
TRACED_RANGE = "portbench.traced"
#: A kernel's name in the breakdown is cut to this many characters (a
#: templated PyTorch kernel's full name runs to a thousand).
NAME_CHARS = 160


@dataclass
class TraceSummary:
    """What a traced sub-window showed."""

    window_s: float = 0.0
    busy_s: float = 0.0
    launches: int = 0
    syncs: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)   # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)    # [[host range, seconds]]


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host: list, points: list) -> list:
    """For each of the sorted ``points``, the name of the innermost range of
    ``host`` ([(start, end, name)] on one thread, sorted by start, nested)
    that contains it, or ``"(no host range)"``."""
    names, stack, k = [], [], 0
    for p in points:
        while k < len(host) and host[k][0] <= p:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][2] if stack else "(no host range)")
    return names


def summarize(events: list, top: int = 10) -> TraceSummary:
    """Reduce a Chrome trace's events to a :class:`TraceSummary` over the
    span of the :data:`TRACED_RANGE` range."""
    marks = [e for e in events if e.get("name") == TRACED_RANGE
             and e.get("ph") == "X"]
    if not marks:
        raise ValueError(f"the trace has no {TRACED_RANGE!r} range")
    mark = marks[0]
    t0, t1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    tid = mark.get("tid")

    def inside(e):
        return (e.get("ph") == "X" and t0 <= float(e["ts"])
                and float(e["ts"]) + float(e.get("dur", 0)) <= t1)

    dev = [e for e in events if e.get("cat") in _DEVICE_CATS and inside(e)]
    busy = _merge([[float(e["ts"]), float(e["ts"]) + float(e["dur"])]
                   for e in dev])
    busy_us = sum(b - a for a, b in busy)
    per_op: dict = {}
    for e in dev:
        per_op[e["name"]] = per_op.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    host_calls = [e for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and inside(e)]
    names = [e["name"] for e in host_calls] + [e["name"] for e in dev]
    syncs = {label: sum(1 for n in names if re.search(pat, n))
             for label, pat in SYNC_SUMS.items()}
    launches = sum(1 for e in host_calls if LAUNCH_CALLS.match(e["name"]))

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events
                  if e.get("cat") in _HOST_CATS and e.get("tid") == tid
                  and e["name"] != TRACED_RANGE and inside(e))
    gaps, prev = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    labels = _innermost(host, [m for m, _ in mids])
    idle: dict = {}
    for (_, length), name in zip(mids, labels):
        idle[name] = idle.get(name, 0.0) + length * 1e-6

    def top_of(d):
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return TraceSummary(window_s=(t1 - t0) * 1e-6, busy_s=busy_us * 1e-6,
                        launches=launches, syncs=syncs,
                        device_ops=top_of(per_op), idle_gaps=top_of(idle))


@contextlib.contextmanager
def traced(result: dict):
    """Profile the block (host and device) inside a :data:`TRACED_RANGE`
    range; when it ends, ``result["summary"]`` holds the
    :class:`TraceSummary`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(TRACED_RANGE):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    result["summary"] = summarize(events)

