"""Profiling: the program's spans and counters, and the Chrome-trace
exporter — the structured replacement for the reference's manual
BenchmarkTools sprinkling and comment history (SURVEY.md §5).

A span (:func:`span`) marks a phase of the program and a counter
(:func:`count`) counts events at the same boundaries. Both record only
while a ``torch.profiler`` session records ("recording"). Otherwise
:func:`span` returns one shared no-op object (no allocation, no clock, no
``record_function``) and :func:`count` returns at once.

While recording, a span opens ``torch.profiler.record_function(name)``, so
it sits in the profiler's Chrome trace as a ``user_annotation`` range on the
profiler's clock, beside the device's kernels and copies, and labels the
idle gaps under it. It is also kept in memory (:class:`SpanRecord`): name,
start and end on ``time.perf_counter_ns``, parent span, thread, and the id
of the call or step it belongs to. A root span (``root=True``) opens a new
id. The parent stack is per thread; the id is module-wide, so the spans
that autograd's worker thread opens in a backward take the id of the step
that started it. Nothing here synchronises the card.

Names: ``rtw.render.*`` (the strided forward call), ``rtw.grad.*`` (the
gradient step), ``rtw.sync.<site>`` (one blocking host read each, which
also counts itself under its name), ``rtw.ckpt.*`` (the checkpointed
drivers' phases, :class:`utils.metrics.PhaseTimer`), ``rtw.rays`` (film
coordinates and camera rays of the wavefront routes). :func:`summary`
reduces them, with every counter. Kernel launches are counted by the
kernel wrappers themselves (``chip_smoke.counts``), not here.

The JAX package's ``compile_stats`` (an XLA lowering's compile time and
memory) has no counterpart here: the port lowers nothing through XLA, and
its kernels are built once by ``ops/cuda/build.py`` and cached.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

class SpanRecord(NamedTuple):
    """One closed span."""

    name: str
    start_ns: int      # time.perf_counter_ns
    end_ns: int
    span_id: int
    parent_id: int | None   # the enclosing span on the same thread
    thread: int             # threading.get_ident()
    call_id: int            # the call or step it belongs to


class _NoSpan:
    """What :func:`span` returns when not recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self) -> None:
        pass


_NO_SPAN = _NoSpan()
_spans: list[SpanRecord] = []
_counts: dict[str, int] = {}
_count_lock = threading.Lock()
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)
_call_id = 0
_local = threading.local()


class _Span:
    """A span while recording: opened by ``__enter__``, closed by
    :meth:`close` (or ``__exit__``; a second close does nothing), on the
    thread that opened it."""

    __slots__ = ("name", "root", "rf", "span_id", "parent_id", "call_id",
                 "start_ns", "open")

    def __init__(self, name: str, root: bool):
        self.name = name
        self.root = root
        self.open = False

    def __enter__(self):
        global _call_id
        if self.root:
            _call_id = next(_call_ids)
        stack = _stack()
        self.parent_id = stack[-1].span_id if stack else None
        self.span_id = next(_span_ids)
        self.call_id = _call_id
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.open = True
        self.start_ns = time.perf_counter_ns()
        return self

    def close(self) -> None:
        if not self.open:
            return
        end = time.perf_counter_ns()
        self.open = False
        self.rf.__exit__(None, None, None)
        _stack().remove(self)
        _spans.append(SpanRecord(self.name, self.start_ns, end, self.span_id,
                                 self.parent_id, threading.get_ident(),
                                 self.call_id))

    def __exit__(self, *exc):
        self.close()
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, root: bool = False):
    """A context manager marking the phase ``name`` (see the module
    docstring); ``root=True`` opens a new call or step id. Its object's
    ``close()`` ends the span before the ``with`` block does."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, root)


def spanned(name: str, root: bool = False):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, root):
                return fn(*args, **kwargs)
        return inner
    return wrap


def sync(site: str):
    """The span of one blocking host read, ``rtw.sync.<site>``, counted
    under that name."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    name = "rtw.sync." + site
    count(name)
    return _Span(name, False)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def recording() -> bool:
    """Whether spans and counters record now (a profiler runs): what a
    counter that needs a host read checks first, so that it reads nothing
    with the profiler off."""
    return _autograd_profiler._is_profiler_enabled


def spans() -> list[SpanRecord]:
    """The spans closed since the last :func:`reset`, in closing order."""
    return list(_spans)


def summary() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: n}}``: per span name its count, total host time and self time
    (total less what its children, on its thread, cover); every counter.
    Spans and counters come only from recording, so both are empty unless
    a profiler ran."""
    recs = list(_spans)
    child_ns: dict[int, int] = {}
    for r in recs:
        if r.parent_id is not None:
            child_ns[r.parent_id] = (child_ns.get(r.parent_id, 0)
                                     + r.end_ns - r.start_ns)
    out: dict = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        dur = r.end_ns - r.start_ns
        s["count"] += 1
        s["total_s"] += dur * 1e-9
        s["self_s"] += (dur - child_ns.get(r.span_id, 0)) * 1e-9
    with _count_lock:
        counters = dict(_counts)
    return {"spans": out, "counters": counters}


def reset() -> None:
    """Forget every span and counter."""
    _spans.clear()
    with _count_lock:
        _counts.clear()


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (the host and, where CUDA is
    available, the card) and write it as a Chrome trace
    ``<log_dir>/trace.json`` when the block ends; the program's spans are
    in it. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
