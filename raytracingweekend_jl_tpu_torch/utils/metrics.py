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

from .profiling import span

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
    """Per-phase wall timers of the checkpointed drivers (``trace``,
    ``fetch``, ``checkpoint``) — the structured stand-in for the
    reference's BenchmarkTools sprinkling (SURVEY.md §5).

    Phase ``p`` is the program span ``rtw.ckpt.<p>``
    (:func:`utils.profiling.span`): :meth:`start` opens it and :meth:`stop`
    closes it, and ``totals`` sums its host time on every run, recording or
    not. ``trace`` is the host's enqueue of a chunk's render: the card
    returns before it has finished, so ``fetch``, the copy of the chunk's
    sums to the host, holds the card's time."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self._open: dict[str, tuple] = {}

    def start(self, phase: str) -> None:
        s = span("rtw.ckpt." + phase)
        s.__enter__()
        self._open[phase] = (s, time.perf_counter())

    def stop(self, phase: str) -> None:
        s, t0 = self._open.pop(phase)
        s.close()
        self.totals[phase] = (self.totals.get(phase, 0.0)
                              + time.perf_counter() - t0)

    def discard(self, phase: str) -> None:
        """Close an open phase without accumulating (e.g. a failed
        attempt)."""
        s, _ = self._open.pop(phase, (None, None))
        if s is not None:
            s.close()

    def as_dict(self) -> dict:
        return {k: round(v, 4) for k, v in sorted(self.totals.items())}
