"""Metrics and benchmark history: every run appends one JSON record, so
regressions are diffable by machines (the reference keeps its timing history
as comments, SURVEY.md §5).

The records carry the JAX package's keys and rounding, plus ``device``: the
card's name and power limit, so that no rate stands without its card. The
history file is the port's own, ``bench_history_torch.jsonl``:
``bench_history.jsonl`` holds the JAX package's TPU rows.
"""

from __future__ import annotations

import json
import platform
import subprocess
import time

import torch

#: The port's history file; the JAX package's is ``bench_history.jsonl``.
HISTORY_FILE = "bench_history_torch.jsonl"


def device_info(device=None) -> dict:
    """``{"name", "power_limit_w"}`` of the card ``device`` (the current
    one by default): the name from ``torch.cuda.get_device_name`` and the
    power limit in watts from ``nvidia-smi``. Both ``None`` for the CPU;
    the limit ``None`` where ``nvidia-smi`` is missing or says nothing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {"name": None, "power_limit_w": None}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True)
        limit = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"name": torch.cuda.get_device_name(index), "power_limit_w": limit}


def throughput_record(label: str, wall_s: float, n_paths: int,
                      extra: dict | None = None, device=None) -> dict:
    """One history record: the JAX package's keys and rounding, plus
    ``device`` (:func:`device_info` of ``device``)."""
    rec = {
        "ts": time.time(),
        "label": label,
        "wall_s": round(wall_s, 4),
        "paths": n_paths,
        "mpaths_per_s": round(n_paths / wall_s / 1e6, 3),
        "host": platform.node(),
        "device": device_info(device),
    }
    if extra:
        rec.update(extra)
    return rec


def append_history(rec: dict, path: str = HISTORY_FILE) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


class PhaseTimer:
    """Per-phase wall timers (e.g. trace, fetch, checkpoint) — the structured
    stand-in for the reference's BenchmarkTools sprinkling (SURVEY.md §5)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self._t0: dict[str, float] = {}

    def start(self, phase: str) -> None:
        self._t0[phase] = time.time()

    def stop(self, phase: str) -> None:
        self.totals[phase] = (self.totals.get(phase, 0.0) + time.time()
                              - self._t0.pop(phase))

    def discard(self, phase: str) -> None:
        """Drop an open timer without accumulating (e.g. a failed attempt)."""
        self._t0.pop(phase, None)

    def as_dict(self) -> dict:
        return {k: round(v, 4) for k, v in sorted(self.totals.items())}
