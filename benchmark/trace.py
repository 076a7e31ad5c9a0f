"""The traced slice of a run: device busy time, idle gaps and kernel time
by name from ``torch.profiler``, and CUDA-event timing.

``Tracer`` starts the profiler before a warm-up call, so CUPTI's start-up
falls outside the slice, and marks the slice itself with a
``bench.slice`` span that ends after a synchronize.  Only device
operations inside that span count.  Busy time is the union of the device
operations' intervals (kernels, copies, sets; the profiler's own user
annotations on the device timeline are left out), so overlapping streams
are not counted twice.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, List, Tuple

import torch

SLICE = "bench.slice"


def span(name: str, traced: bool):
    """A span from the benchmark's side around a call into a layer,
    recorded in a traced run only."""
    return torch.profiler.record_function(name) if traced else nullcontext()


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def summarize(device_ops, host_ops, lo: float, hi: float, top: int = 10):
    """From device ops (name, start, end) and host ops (name, start, end,
    depth) in seconds, over the slice [lo, hi): busy seconds, kernel
    seconds and counts by name, the ``top`` device ops by time and the ``top``
    longest idle gaps named by what the host was doing at each gap's
    middle (its innermost operation)."""
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device_ops
              if e > lo and s < hi]
    iv = [(s, e) for _, s, e in inside]
    by_name, count = {}, {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        count[n] = count.get(n, 0) + 1
    idle = sorted(gaps(iv, lo, hi), key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in idle:
        mid = (s + e) / 2
        live = [(d, n) for n, hs, he, d in host_ops if hs <= mid < he]
        named.append([max(live)[1] if live else "host, outside any traced op",
                      e - s])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": union_length(iv), "window_s": hi - lo,
            "kernel_s": by_name, "kernel_n": count,
            "breakdown": {"device_ops": [[n, t] for n, t in ops],
                          "idle_gaps": named}}


class Tracer:
    """Started before a warm-up call; ``slice(body)`` traces ``body`` and
    stops the profiler; ``summary()`` reads the slice."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    def slice(self, body: Callable[[], None]) -> None:
        sync = (torch.cuda.synchronize if torch.cuda.is_available()
                else lambda: None)
        sync()
        with torch.profiler.record_function(SLICE):
            body()
            sync()
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        from torch.autograd import DeviceType
        dev, host, bounds = [], [], None
        for e in self.prof.events():
            s = e.time_range.start / 1e6
            t = e.time_range.end / 1e6
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    dev.append((e.name, s, t))
            elif e.name == SLICE:
                bounds = (s, t)
            else:
                host.append((e.name, s, t, _depth(e)))
        if bounds is None:
            raise RuntimeError("the profiler recorded no slice span")
        return summarize(dev, host, *bounds)


def _depth(e) -> int:
    d, p = 0, getattr(e, "cpu_parent", None)
    while p is not None:
        d, p = d + 1, getattr(p, "cpu_parent", None)
    return d


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events over ``iters``
    calls after ``warmup`` (a frozen copy of ``chip_smoke.py``'s)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
