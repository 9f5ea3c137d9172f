#!/usr/bin/env python3
"""Every blocking host read of the benchmark's driven routes, located on the
card, and the cost of the program's spans.

    python3 scripts/torch_sync_sites.py [--cells a,b] [--seed n]
        [--out sync_sites.json] [--cpu]

For each cell of ``BENCHMARK.json`` (all of them by default) it builds the
cell's inputs (``portbench.loops``), makes one warm call, then one call of
the program (``render_tile_sum`` or ``render_grads``) inside a
``torch.profiler`` session, so the program's spans record, with
``torch.cuda.set_sync_debug_mode("warn")`` on. Reported per cell:

- ``sites``: each synchronising operation PyTorch warns of, by the
  program's innermost frame (``file:line function``), with how often the
  call passed it and the innermost program span open on its thread
  (``not_program``: warnings from no frame of the program, such as the
  switch of the debug mode itself);
- ``outside``: those not inside an ``rtw.sync.*`` span;
- ``runtime_outside``: the runtime's synchronising calls of the profiler
  trace (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaMemcpy``) during the call that lie inside no ``rtw.sync.*`` range
  (nor, for a gradient step, ``rtw.grad.backward``) on their thread;
- ``profiler_syncs``: the call's syncs as ``host_syncs_per_mpath.render``
  counts them (``portbench.harness.profile.SYNC_SUMS``) beside the
  program's counters (``utils.profiling.summary``).

Then the host cost of ``span``, ``sync`` and ``count`` a use with no
profiler running, and of ``span`` while one records (CPU activity).
Exits 1 when any read lies outside a sync span. ``--cpu`` rehearses on the
CPU at a tiny film (nothing synchronises there). Needs the card otherwise;
it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import tempfile
import threading
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench.harness.profile import SYNC_SUMS  # noqa: E402
from portbench.harness.spec import load_cell, load_json  # noqa: E402
from raytracingweekend_jl_tpu_torch.utils import profiling  # noqa: E402

PKG = os.path.join(ROOT, "raytracingweekend_jl_tpu_torch")
#: Runtime calls that make the host wait for the card.
RUNTIME_SYNC = re.compile(r"^(cudaStreamSynchronize|cudaDeviceSynchronize|"
                          r"cudaMemcpy)(_v\d+)?$")
#: A tiny film for ``--cpu``.
TINY = {"width": 32, "height": 18,
        "check": {"blocks": [4, 3], "reference_jittered_spp": 4,
                  "reference_steps": 2}}


def _site(stack) -> str | None:
    """The program's innermost frame, or None outside the program."""
    frames = [f for f in stack if f.filename.startswith(PKG)]
    if not frames:
        return None
    f = frames[-1]
    return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"


def _program_call(loop, kind: str, seed: int):
    if kind == "render":
        return lambda: loop.program(seed, 0)
    return lambda: loop.program(seed)


def _ranges(events: list) -> dict:
    """``{tid: [(start, end, name)]}`` of the trace's program ranges."""
    out: dict = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith("rtw.")):
            t0 = float(e["ts"])
            out.setdefault(e.get("tid"), []).append(
                (t0, t0 + float(e.get("dur", 0)), e["name"]))
    return out


def _runtime_outside(events: list, allowed) -> list:
    """The runtime's synchronising calls, on any thread, inside the call's
    root range (``rtw.render.call`` or ``rtw.grad.step``) and inside no
    range that ``allowed`` names on their own thread."""
    ranges = _ranges(events)
    roots = [(a, b) for rs in ranges.values() for a, b, n in rs
             if n in ("rtw.render.call", "rtw.grad.step")]
    bad = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("cuda_runtime",
                                                      "cuda_driver"):
            continue
        if not RUNTIME_SYNC.match(e["name"]):
            continue
        t = float(e["ts"])
        if not any(a <= t <= b for a, b in roots):
            continue
        inside = [n for a, b, n in ranges.get(e.get("tid"), [])
                  if a <= t <= b]
        if not any(allowed(n) for n in inside):
            bad.append({"name": e["name"], "ts": t,
                        "ranges": sorted(set(inside))})
    return bad


def _profiler_syncs(events: list) -> dict:
    names = [e["name"] for e in events if e.get("ph") == "X" and (
        e.get("cat") in ("cuda_runtime", "cuda_driver", "kernel",
                         "gpu_memcpy", "gpu_memset"))]
    return {k: sum(1 for n in names if re.search(p, n))
            for k, p in SYNC_SUMS.items()}


def locate(cell_name: str, seed: int, device: str, overrides) -> dict:
    """One call of the cell's program with every sync located."""
    import importlib
    cell = load_cell(cell_name, ROOT)
    kind = cell.traffic["loop"]
    loops = importlib.import_module(f"portbench.loops.{kind}")
    loop = loops.Loop(cell, seed, device, overrides=overrides)
    loop.warm()
    call = _program_call(loop, kind, seed + 1)
    on_card = device != "cpu"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    events_seen: list = []
    real_show = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return real_show(message, category, filename, lineno, file, line)
        stack = profiling._stack()
        events_seen.append({
            "site": _site(traceback.extract_stack()),
            "span": stack[-1].name if stack else None,
            "thread": threading.get_ident()})

    profiling.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with torch.profiler.profile(activities=acts) as prof:
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
            if on_card:
                torch.cuda.synchronize()
    summary = profiling.summary()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data

    def allowed(name):
        return name.startswith("rtw.sync.") or (
            kind == "grad" and name == "rtw.grad.backward")

    program = [e for e in events_seen if e["site"] is not None]
    sites: dict = {}
    for ev in program:
        s = sites.setdefault(ev["site"], {"count": 0, "spans": set()})
        s["count"] += 1
        s["spans"].add(ev["span"])
    sites = {k: {"count": v["count"], "spans": sorted(map(str, v["spans"]))}
             for k, v in sorted(sites.items())}
    counters = summary["counters"]
    return {
        "cell": cell_name, "kind": kind,
        "sites": sites,
        "outside": [e for e in program
                    if not str(e["span"]).startswith("rtw.sync.")],
        "not_program": len(events_seen) - len(program),
        "runtime_outside": _runtime_outside(events, allowed),
        "profiler_syncs": _profiler_syncs(events),
        "program_syncs": {k: v for k, v in counters.items()
                          if k.startswith("rtw.sync.")},
        "counters": {k: v for k, v in counters.items()
                     if not k.startswith("rtw.sync.")},
        "spans": {k: {"count": v["count"], "total_ms": v["total_s"] * 1e3,
                      "self_ms": v["self_s"] * 1e3}
                  for k, v in summary["spans"].items()},
    }


def span_cost(n: int = 200_000) -> dict:
    """Host microseconds a use of ``span``, ``sync`` and ``count`` with no
    profiler running (less an empty loop's), and of ``span`` while a
    profiler records; medians of five repeats."""
    def per_use(body, reps=5, m=n):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            body(m)
            out.append((time.perf_counter() - t0) / m * 1e6)
        return statistics.median(out)

    def empty(m):
        for _ in range(m):
            pass

    def spans(m):
        for _ in range(m):
            with profiling.span("rtw.cost"):
                pass

    def syncs(m):
        for _ in range(m):
            with profiling.sync("cost"):
                pass

    def counts(m):
        for _ in range(m):
            profiling.count("rtw.cost")

    base = per_use(empty)
    off = {"span_us": per_use(spans) - base, "sync_us": per_use(syncs) - base,
           "count_us": per_use(counts) - base, "empty_loop_us": base}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = per_use(spans, reps=3, m=n // 20) - base
    profiling.reset()
    return {"off": off, "on_span_us": on}


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default=None)
    p.add_argument("--seed", type=int, default=2300000777)
    p.add_argument("--out", default="sync_sites.json")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if args.cpu:
        device, overrides = "cpu", TINY
    else:
        if not torch.cuda.is_available():
            print("torch_sync_sites: needs the card; --cpu rehearses",
                  file=sys.stderr)
            return 3
        device, overrides = "cuda:0", None
    cells = (args.cells.split(",") if args.cells else
             [w["name"] for w in load_json(ROOT, "BENCHMARK.json")
              ["workloads"]])
    result = {"device": (torch.cuda.get_device_name(0) if device != "cpu"
                         else "cpu"),
              "torch": torch.__version__, "cells": []}
    for name in cells:
        r = locate(name, args.seed, device, overrides)
        result["cells"].append(r)
        print(json.dumps({"cell": name, "sites": r["sites"],
                          "outside": len(r["outside"]),
                          "runtime_outside": len(r["runtime_outside"]),
                          "profiler_syncs": r["profiler_syncs"],
                          "program_syncs": r["program_syncs"],
                          "counters": r["counters"]}), flush=True)
    result["span_cost"] = span_cost()
    print(json.dumps({"span_cost": result["span_cost"]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    bad = sum(len(r["outside"]) + len(r["runtime_outside"])
              for r in result["cells"])
    print(f"torch_sync_sites: {bad} blocking reads outside a sync span",
          file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
