"""The program's own spans and counters, for the per-layer metrics that
read them: ``utils.profiling.summary()`` of the port. The program records
them only while a profiler runs, so in a run of the harness they hold the
traced sub-window alone. A program that has no ``summary`` (one older than
its spans) gives None, and so does every reader."""

from __future__ import annotations

#: The root span of one call or step of each kind of loop.
ROOTS = {"render": "rtw.render.call", "grad": "rtw.grad.step"}


def program_summary(run, kind: str):
    """The program's summary when ``run`` is a traced run of loop ``kind``
    and the program counted at least one root span, else None."""
    if run.kind != kind or run.traced is None:
        return None
    try:
        from raytracingweekend_jl_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    s = summary()
    if not roots(s, kind):
        return None
    return s


def roots(summary: dict, kind: str) -> int:
    """The calls or steps the program counted."""
    return summary["spans"].get(ROOTS[kind], {}).get("count", 0)


def total_s(summary: dict, name: str) -> float | None:
    """The host seconds of every span ``name``, or None if there is none."""
    s = summary["spans"].get(name)
    return None if s is None else s["total_s"]


def syncs(summary: dict) -> int:
    """The blocking host reads the program counted (``rtw.sync.*``)."""
    return sum(n for k, n in summary["counters"].items()
               if k.startswith("rtw.sync."))
