"""Spans and stages inside the port: where a training step's time and the
set-up's time go.

:func:`span` times hot-path work (a training step, its forward, backward
and optimizer phases, ``PlanSpmm``'s passes).  It records only while a
``torch.profiler`` records, and then opens a ``record_function`` range
(so the span sits in the profiler's trace) and records a CUDA event pair
on the current stream (on the CPU, whose work is synchronous, it reads
the host clock at entry and exit instead).  Without a profiler it costs
one flag read.  Per name it keeps the count and the device seconds: the
event pairs, read when :func:`totals` is called, after each pair's end
has completed.  A span may be entered from the autograd engine's
threads, where backward passes run.

:func:`stage` times one-shot set-up work (kernel builds, graph
preparation, plan tables, sketches, features, staging).  It always records: the host clock at
entry, a device synchronize at exit, the host clock again.  Stages nest;
a stage's self time is its duration less its child stages' durations.
Stages belong at set-up call sites only, never inside a function that a
training step or a scored request calls: a stage synchronizes.

Both kinds stay in memory until :func:`reset` (:func:`reset_spans`
forgets the spans alone); :func:`totals` and :func:`stage_totals` read
them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Iterator, List

import torch
from torch.autograd import profiler as _profiler

_NULL = nullcontext()
# event pairs held before their ends are queried for finished ones
_PENDING_FOLD = 1024

_lock = threading.Lock()
_spans: Dict[str, List[float]] = {}   # name -> [count, device s]
_pending: list = []                   # (name, start event, end event)
_stages: List["StageRecord"] = []
_open = threading.local()             # this thread's stack of open stages


def recording() -> bool:
    """Whether a ``torch.profiler`` is recording (the flag it sets)."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "_range", "_start", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = None
        if torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = None
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            host_s = (time.perf_counter_ns() - self._t0) / 1e9
        self._range.__exit__(*exc)
        with _lock:
            agg = _spans.setdefault(self.name, [0, 0.0])
            agg[0] += 1
            if end is None:
                agg[1] += host_s
            else:
                _pending.append((self.name, self._start, end))
                if len(_pending) >= _PENDING_FOLD:
                    _fold(wait=False)
        return False


def span(name: str):
    """A context timing hot-path work (module docstring); a shared no-op
    context while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def _fold(wait: bool) -> None:
    """Add the finished event pairs' device seconds to their spans (all
    of them with ``wait``, after their ends complete).  Holds ``_lock``."""
    keep = []
    for name, start, end in _pending:
        if wait:
            end.synchronize()
        elif not end.query():
            keep.append((name, start, end))
            continue
        _spans[name][1] += start.elapsed_time(end) / 1e3
    _pending[:] = keep


def totals() -> Dict[str, dict]:
    """``{name: {count, device_s}}`` of every span recorded since the
    last :func:`reset_spans`."""
    with _lock:
        _fold(wait=True)
        return {n: {"count": int(c), "device_s": d}
                for n, (c, d) in _spans.items()}


@dataclasses.dataclass
class StageRecord:
    """One stage: its name, host-clock start and end (seconds) and the
    seconds its child stages took."""

    name: str
    start: float
    end: float = float("nan")
    child_s: float = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def self_seconds(self) -> float:
        return self.seconds - self.child_s


def _sync(device) -> None:
    if device is None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def stage(name: str, device=None) -> Iterator[StageRecord]:
    """A context timing one-shot set-up work (module docstring); yields
    its :class:`StageRecord`.  ``device``: the device to synchronize at
    exit (default: the current CUDA device where CUDA is in use).  A
    stage whose body raises is not recorded."""
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    rec = StageRecord(name, time.perf_counter())
    stack.append(rec)
    try:
        with torch.profiler.record_function(name) if recording() else _NULL:
            yield rec
            _sync(device)
    finally:
        stack.pop()
    rec.end = time.perf_counter()
    if stack:
        stack[-1].child_s += rec.seconds
    with _lock:
        _stages.append(rec)


def stage_totals() -> Dict[str, float]:
    """``{name: self seconds}``, summed over the stages of that name
    recorded since the last :func:`reset`."""
    out: Dict[str, float] = {}
    with _lock:
        for r in _stages:
            out[r.name] = out.get(r.name, 0.0) + r.self_seconds
    return out


def reset_spans() -> None:
    """Forget every span recorded so far (the stages stay)."""
    with _lock:
        _spans.clear()
        _pending.clear()


def reset() -> None:
    """Forget every span and stage recorded so far."""
    reset_spans()
    with _lock:
        _stages.clear()
