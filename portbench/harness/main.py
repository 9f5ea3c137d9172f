"""Run one cell once and print its result line.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: set-up (inputs from the seed, the program's objects, one
warm call at the cell's shapes), a closed-loop window of ``--seconds``,
with ``--trace 1`` a traced sub-window after it, then the check against
the plain reference. The loop, its set-up and its check are the traffic
mix's loop module (:func:`loop_module`); the metrics read the run by the
module's kind (:class:`Run`). The last line of standard output is one JSON
object; the numbers compared, each beside its limit, close standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

from . import profile
from .spec import PKG, ROOT, load_cell

#: Top-level modules the run must not have loaded: JAX, and the JAX
#: package the program was ported from (compared whole, so the program's
#: own ``raytracingweekend_jl_tpu_torch`` passes).
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracingweekend_jl_tpu")


def loop_module(cell):
    """The cell's loop, ``portbench/loops/<loop>.py``, ``<loop>`` the
    traffic mix's ``loop``."""
    return importlib.import_module(f"portbench.loops.{cell.traffic['loop']}")


class Run:
    """What one run measured; the metric readers take their numbers from
    it.

    ``kind`` is the loop module's ``KIND`` (``"render"`` or ``"grad"``), or
    its file name where it sets none: the readers of a kind read the runs
    of every loop of that kind, so a new loop, with its own plain
    reference, reports the metrics of its kind. ``roofline`` is found by
    the loop's file name, ``portbench/roofline/<loop>.py``: each loop
    counts its own work."""

    def __init__(self, cell):
        loop = cell.traffic["loop"]
        self.kind = getattr(loop_module(cell), "KIND", loop)
        self.roofline = importlib.import_module(f"portbench.roofline.{loop}")
        self.setup_s = 0.0
        self.call_s: list[float] = []
        self.window_s = 0.0
        self.paths = 0
        self.traced = None            # profile.TraceSummary
        self.traced_paths = 0
        self.traced_calls = 0
        self.peak_bytes = 0
        self.step_peak_bytes = 0
        self.loop = None

    def least_time_s(self, paths: int) -> dict:
        """The least time the work of ``paths`` paths could take at the
        published peaks (:mod:`portbench.harness.peaks`), and which peak
        bounds it."""
        from .peaks import least_time
        return least_time(self.roofline.work(self.loop, paths))


def load_reader(name: str, pkg: str = PKG):
    """The reader of metric ``name``: ``<pkg>/metrics/<name>.py``, loaded by
    its path, since a metric's name may hold dots."""
    path = os.path.join(pkg, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._" + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(x: float):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float, variant: str = "port",
             overrides: dict | None = None) -> dict:
    """One run's result line; ``t0`` is the process's start on
    :func:`time.perf_counter`."""
    run = Run(cell)
    loop = loop_module(cell).Loop(cell, seed, device, variant, overrides)
    run.loop = loop
    loop.warm()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    # The reference's own work in set-up (a loop's ``reference_s``, such as
    # the grad cell's target image) is the benchmark's, not the program's.
    run.setup_s = start - t0 - getattr(loop, "reference_s", 0.0)
    while True:
        a = time.perf_counter()
        run.paths += loop.call()
        b = time.perf_counter()
        run.call_s.append(b - a)
        if b - start >= seconds:
            break
    run.window_s = b - start
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated()
        run.step_peak_bytes = run.peak_bytes - base
    if trace:
        span = min(max(seconds / 4.0, 2.0), 5.0)
        res: dict = {}
        with profile.traced(res):
            a = time.perf_counter()
            while True:
                with torch.profiler.record_function("portbench.call"):
                    run.traced_paths += loop.call()
                run.traced_calls += 1
                if time.perf_counter() - a >= span:
                    break
        run.traced = res["summary"]
    attempted = len(run.call_s) + run.traced_calls
    loop.free()
    t_check = time.perf_counter()
    readings = loop.check()
    print(f"portbench: setup {run.setup_s:.3f} s, window {run.window_s:.3f} "
          f"s ({len(run.call_s)} calls), traced {run.traced_calls} calls, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = {k: {"value": _finite(v), "limit": cell.limits[k]}
              for k, v in readings.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(torch.device(device))
                    if on_card else "cpu"),
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.traced.busy_s
        dev["window_s"] = run.traced.window_s
        result["breakdown"] = {"device_ops": run.traced.device_ops,
                               "idle_gaps": run.traced.idle_gaps}
    result["checks"] = checks
    return result


def main(argv: list[str], t0: float, allow_cpu: bool = False,
         variant: str = "port", overrides: dict | None = None) -> int:
    """The command line. ``allow_cpu`` (tests only) skips the look for a
    card and runs on the CPU, where the program runs its kernels' plain
    versions; ``variant`` and ``overrides`` plant a fault or shrink the
    traffic there."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload, ROOT)
    if allow_cpu:
        device = "cpu"
    else:
        if not torch.cuda.is_available():
            print("portbench: CUDA is not available; no result",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found; no result",
                  file=sys.stderr)
            return 3
        device = "cuda:0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t0, variant, overrides)
    # Last, after the check and every metric's reader: whatever any of them
    # loaded counts.
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0
