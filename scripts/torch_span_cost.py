#!/usr/bin/env python3
"""What the program's spans cost while a profiler records, and what that
does to the per-layer metrics that read them.

    python3 scripts/torch_span_cost.py [--cells a,b] [--seed n]
        [--rounds 6] [--out span_cost.json] [--cpu]

(``--cells ""`` measures the spans alone and no cell.)

For each cell of ``BENCHMARK.json`` (all by default) it builds the cell's
inputs (``portbench.loops``) and warms them, then runs ``--rounds`` rounds.
A round is one block of the harness's calls with no profiler (``off``),
then one ``torch.profiler`` session (host and card, as the harness's
traced sub-window, ``cuda.<mode>``) holding one block in each mode, in
an order that turns with the round, then one session of the host alone
(``cpu.<mode>``, modes ``noop`` and ``live``):

- ``noop``: every span and counter forced to the shared no-op;
- ``nosync``: the ``rtw.sync.*`` spans forced off, the others recording;
- ``live``: everything recording, as in the harness;
- ``live_norf``: recording, with ``record_function`` replaced by a null
  context (the span kept in memory, nothing in the trace).

Per mode it reports the calls' host milliseconds (median and quartiles of
the blocks' means), the host time spent inside the spans' own code
(``_Span.__enter__`` and ``close``, and of that inside
``record_function``), in all and by span name, the program-span metrics
as the benchmark's readers compute them, and from the session's Chrome
trace the block's device idle share and its idle seconds by innermost
host range (``portbench``'s ``summarize``). Last, the cost of one span
alone under the profiler: with the card idle, with the card busy, around
a blocking read, and with the host alone profiled. ``--cpu`` rehearses on
the CPU at a tiny film. Needs the card otherwise; it never falls back to
the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import statistics
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench.harness import profile  # noqa: E402
from portbench.harness.main import load_reader  # noqa: E402
from portbench.harness.spec import load_cell, load_json  # noqa: E402
from raytracingweekend_jl_tpu_torch.utils import profiling  # noqa: E402

MODES = ("noop", "nosync", "live", "live_norf")
CPU_MODES = ("noop", "live")
#: Calls a block, by loop kind, on the card and on the CPU.
BLOCK = {"render_1080p": 6, "render_96px": 60, "grad_1080p": 6}
TINY = {"width": 32, "height": 18,
        "check": {"blocks": [4, 3], "reference_jittered_spp": 4,
                  "reference_steps": 2}}
BLOCK_RANGE = "probe.block"


class _Timers:
    """Host nanoseconds spent inside the spans' own code."""

    def __init__(self):
        self.span_ns = 0
        self.rf_ns = 0
        self.spans = 0
        self.by_name: dict = {}   # name -> [spans, span ns, rf ns]

    def add(self, name: str, k: int, ns: int) -> None:
        row = self.by_name.setdefault(name, [0, 0, 0])
        row[k] += ns


def _install_timers(t: _Timers):
    """Wrap ``_Span.__enter__``/``close`` and ``record_function`` so that
    their host time adds up in ``t``; returns the undo."""
    cls = profiling._Span
    enter, close = cls.__enter__, cls.close
    real_rf = torch.profiler.record_function

    def timed_enter(self):
        a = time.perf_counter_ns()
        r = enter(self)
        ns = time.perf_counter_ns() - a
        t.span_ns += ns
        t.spans += 1
        t.add(self.name, 0, 1)
        t.add(self.name, 1, ns)
        return r

    def timed_close(self):
        a = time.perf_counter_ns()
        close(self)
        ns = time.perf_counter_ns() - a
        t.span_ns += ns
        t.add(self.name, 1, ns)

    class TimedRF:
        def __init__(self, name, args=None):
            self.rf = real_rf(name, args)
            self.name = name
            self.mine = name.startswith("rtw.")

        def __enter__(self):
            a = time.perf_counter_ns()
            self.rf.__enter__()
            if self.mine:
                ns = time.perf_counter_ns() - a
                t.rf_ns += ns
                t.add(self.name, 2, ns)
            return self

        def __exit__(self, *exc):
            a = time.perf_counter_ns()
            self.rf.__exit__(*exc)
            if self.mine:
                ns = time.perf_counter_ns() - a
                t.rf_ns += ns
                t.add(self.name, 2, ns)
            return False

    cls.__enter__, cls.close = timed_enter, timed_close
    torch.profiler.record_function = TimedRF

    def undo():
        cls.__enter__, cls.close = enter, close
        torch.profiler.record_function = real_rf
    return undo


class _NullRF:
    def __init__(self, name, args=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@contextlib.contextmanager
def _mode(mode: str):
    """Force the spans into ``mode`` for the block."""
    undo = []
    if mode == "noop":
        real = profiling._autograd_profiler
        profiling._autograd_profiler = types.SimpleNamespace(
            _is_profiler_enabled=False)
        undo.append(lambda: setattr(profiling, "_autograd_profiler", real))
    elif mode == "nosync":
        real_sync = profiling.sync
        for mod in list(sys.modules.values()):
            if (mod is not profiling and getattr(mod, "__name__", "")
                    .startswith("raytracingweekend_jl_tpu_torch")
                    and getattr(mod, "sync", None) is real_sync):
                setattr(mod, "sync", lambda site: profiling._NO_SPAN)
                undo.append(lambda m=mod: setattr(m, "sync", real_sync))
    elif mode == "live_norf":
        real_rf = torch.profiler.record_function

        def rf(name, args=None):
            return _NullRF(name) if name.startswith("rtw.") else real_rf(
                name, args)
        torch.profiler.record_function = rf
        undo.append(lambda: setattr(torch.profiler, "record_function",
                                    real_rf))
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


def _block(loop, n: int) -> list[float]:
    out = []
    for _ in range(n):
        a = time.perf_counter()
        with torch.profiler.record_function("portbench.call"):
            loop.call()
        out.append(time.perf_counter() - a)
    return out


def _readings(kind: str, names: list[str]) -> dict:
    run = types.SimpleNamespace(kind=kind, traced=object())
    out = {}
    for n in names:
        v = load_reader(n).read(run)
        if v is not None:
            out[n] = v
    return out


def _blocks_of(events: list) -> list:
    """The trace's block ranges, by start."""
    return sorted((e for e in events if e.get("name") == BLOCK_RANGE
                   and e.get("ph") == "X"), key=lambda e: float(e["ts"]))


def _trace_of(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _idle_of(events: list, block: dict) -> dict:
    """The block's device idle share and idle labels."""
    renamed = [dict(e, name=profile.TRACED_RANGE) if e is block else e
               for e in events]
    s = profile.summarize(renamed, top=8)
    idle = s.window_s - s.busy_s
    return {"idle_pct": 100.0 * idle / s.window_s if s.window_s else None,
            "idle_s": idle, "labels": s.idle_gaps}


def _quartiles(xs: list[float]) -> dict:
    if len(xs) < 2:
        return {"median": xs[0] if xs else None}
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}


def probe(cell_name: str, seed: int, device: str, rounds: int,
          overrides) -> dict:
    cell = load_cell(cell_name, ROOT)
    kind = cell.traffic["loop"]
    loops = importlib.import_module(f"portbench.loops.{kind}")
    loop = loops.Loop(cell, seed, device, overrides=overrides)
    loop.warm()
    on_card = device != "cpu"
    n = BLOCK[cell_name.split(".", 1)[1]] if on_card else 2
    readers = [m["name"] for m in load_json(ROOT, "BENCHMARK.json")
               ["per_layer"] if m["source"] in ("program_span",
                                                "program_counter")
               and cell_name in m.get("workloads", [])]
    cpu_acts = [torch.profiler.ProfilerActivity.CPU]
    sessions = {"cpu": (cpu_acts, CPU_MODES)}
    if on_card:
        sessions = {"cuda": (cpu_acts + [torch.profiler.ProfilerActivity.CUDA],
                             MODES), **sessions}
    keys = ["off"] + [f"{k}.{m}" for k, (_, ms) in sessions.items()
                      for m in ms]
    per: dict = {k: {"call_ms": [], "span_us_per_call": [],
                     "rf_us_per_call": [], "spans_per_call": [],
                     "by_name": [], "position": [], "readings": [],
                     "idle_pct": [],
                     "labels": []} for k in keys}
    for r in range(rounds):
        per["off"]["call_ms"].append(
            1e3 * statistics.fmean(_block(loop, n)))
        for sname, (acts, modes) in sessions.items():
            order = modes[r % len(modes):] + modes[:r % len(modes)]
            with torch.profiler.profile(activities=acts) as prof:
                for mode in order:
                    t = _Timers()
                    undo = _install_timers(t)
                    profiling.reset()
                    try:
                        with _mode(mode), \
                                torch.profiler.record_function(BLOCK_RANGE):
                            calls = _block(loop, n)
                    finally:
                        undo()
                    p = per[f"{sname}.{mode}"]
                    p["call_ms"].append(1e3 * statistics.fmean(calls))
                    p["span_us_per_call"].append(t.span_ns / n / 1e3)
                    p["rf_us_per_call"].append(t.rf_ns / n / 1e3)
                    p["spans_per_call"].append(t.spans / n)
                    p["by_name"].append(t.by_name)
                    p["position"].append(order.index(mode))
                    p["readings"].append(_readings(kind, readers))
                if on_card:
                    torch.cuda.synchronize()
            profiling.reset()
            if sname != "cuda":
                continue
            events = _trace_of(prof)
            for mode, block in zip(order, _blocks_of(events)):
                idle = _idle_of(events, block)
                per[f"cuda.{mode}"]["idle_pct"].append(idle["idle_pct"])
                per[f"cuda.{mode}"]["labels"].append(idle["labels"])
    out = {"cell": cell_name, "calls_a_block": n, "rounds": rounds,
           "readers": readers, "modes": {}}
    for mode, p in per.items():
        m = {"call_ms": _quartiles(p["call_ms"]),
             "call_ms_blocks": p["call_ms"]}
        if mode != "off":
            names: dict = {}
            for bn in p["by_name"]:
                for k, row in bn.items():
                    acc = names.setdefault(k, [0, 0, 0])
                    for i in range(3):
                        acc[i] += row[i]
            m.update({
                "span_code_us_per_call": _quartiles(p["span_us_per_call"]),
                "record_function_us_per_call": _quartiles(
                    p["rf_us_per_call"]),
                "spans_per_call": _quartiles(p["spans_per_call"]),
                "blocks_us_per_span_by_position": [
                    [pos, us / k if k else None] for pos, us, k in zip(
                        p["position"], p["span_us_per_call"],
                        p["spans_per_call"])],
                "by_name_us_per_span": {
                    k: {"spans": v[0], "code_us": v[1] / v[0] / 1e3,
                        "record_function_us": v[2] / v[0] / 1e3}
                    for k, v in sorted(names.items()) if v[0]},
                "idle_pct": _quartiles([x for x in p["idle_pct"]
                                        if x is not None]),
                "readings": {k: _quartiles([x[k] for x in p["readings"]
                                            if k in x])
                             for k in readers},
                "labels_first_round": p["labels"][0] if p["labels"]
                else None})
        out["modes"][mode] = m
    loop.free()
    return out


def _after_work(device: str, m: int = 400) -> dict:
    import numpy as np
    small = [torch.empty(16) for _ in range(2)]
    big = np.zeros(8 << 20, dtype=np.uint8)
    x = torch.zeros(1024, device=device)

    def ops():
        for _ in range(20):
            small[0].add_(1)
            small[1].mul_(2)
            torch.empty(8)

    def touch():
        big[::64] += 1

    work = {"hot_us": lambda: None, "after_host_ops_us": ops,
            "after_touch_8mb_us": touch,
            "after_sleep_us": lambda: time.sleep(5e-4),
            "after_read_us": lambda: bool(x.any())}
    out = {}
    for key, f in work.items():
        ts = []
        for _ in range(m):
            f()
            a = time.perf_counter_ns()
            with profiling.span("rtw.alone"):
                pass
            ts.append(time.perf_counter_ns() - a)
        out[key] = statistics.median(ts) / 1e3
    return out


def alone(device: str, n: int = 2000) -> dict:
    """Host microseconds of one span's own code (enter and close), under a
    profiler of the host and the card: with the card idle, with the card
    busy on work enqueued before, around a blocking read (less the read
    alone), with the card idle again once the session holds those events,
    and under a profiler of the host alone; then, each span timed by
    itself, back to back (``hot_us``) and after other work that leaves the
    host's caches cold: 60 small host tensor operations, a touch of 8 MB,
    a sleep of 0.5 ms, a blocking read of the card (``after_*_us``)."""
    on_card = device != "cpu"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def spans(m):
        a = time.perf_counter_ns()
        for _ in range(m):
            with profiling.span("rtw.alone"):
                pass
        return (time.perf_counter_ns() - a) / m / 1e3

    x = torch.zeros(1024, device=device)
    big = torch.randn((4096, 4096) if on_card else (64, 64), device=device)

    def reads(m, wrapped):
        a = time.perf_counter_ns()
        for _ in range(m):
            if wrapped:
                with profiling.sync("alone"):
                    bool(x.any())
            else:
                bool(x.any())
        return (time.perf_counter_ns() - a) / m / 1e3

    out = {}
    with torch.profiler.profile(activities=acts):
        spans(n // 10)
        out["idle_us"] = statistics.median(spans(n) for _ in range(3))
        busy = []
        for _ in range(3):
            for _ in range(200 if on_card else 1):
                big @ big
            busy.append(spans(n))
            if on_card:
                torch.cuda.synchronize()
        out["busy_us"] = statistics.median(busy)
        reads(n // 10, False)
        bare = statistics.median(reads(n // 4, False) for _ in range(3))
        wrapped = statistics.median(reads(n // 4, True) for _ in range(3))
        out["around_read_us"] = wrapped - bare
        out["read_us"] = bare
        out["idle_late_us"] = statistics.median(spans(n) for _ in range(3))
        out.update(_after_work(device))
    profiling.reset()
    with torch.profiler.profile(activities=acts[:1]):
        spans(n // 10)
        out["host_profiler_us"] = statistics.median(
            spans(n) for _ in range(3))
    profiling.reset()
    return out


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default=None)
    p.add_argument("--seed", type=int, default=2300000888)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--out", default="span_cost.json")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if args.cpu:
        device, overrides = "cpu", TINY
    else:
        if not torch.cuda.is_available():
            print("torch_span_cost: needs the card; --cpu rehearses",
                  file=sys.stderr)
            return 3
        device, overrides = "cuda:0", None
    cells = ([c for c in args.cells.split(",") if c]
             if args.cells is not None else
             [w["name"] for w in load_json(ROOT, "BENCHMARK.json")
              ["workloads"]])
    result = {"device": (torch.cuda.get_device_name(0) if device != "cpu"
                         else "cpu"),
              "torch": torch.__version__, "cells": []}
    result["alone"] = alone(device)
    print(json.dumps({"alone": result["alone"]}), flush=True)
    for name in cells:
        r = probe(name, args.seed, device, args.rounds, overrides)
        result["cells"].append(r)
        print(json.dumps({"cell": name, **{
            mode: {"call_ms": m["call_ms"]["median"],
                   **({"span_code_us": m["span_code_us_per_call"]["median"],
                       "rf_us": m["record_function_us_per_call"]["median"],
                       "spans": m["spans_per_call"]["median"],
                       "by_name": m["by_name_us_per_span"],
                       "idle_pct": m["idle_pct"].get("median"),
                       "readings": {k: v.get("median")
                                    for k, v in m["readings"].items()}}
                      if mode != "off" else {})}
            for mode, m in r["modes"].items()}}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
