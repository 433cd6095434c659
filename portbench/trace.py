"""A short traced sub-window, and what the benchmark reads from it.

``SubWindow`` runs ``torch.profiler`` (CPU and CUDA activities) from
``start_s`` to ``start_s + length_s`` into the measured window, each end
after a synchronize, and keeps the events in memory. ``Trace`` reduces them:

* ``busy_s``: the union of the device kernels' intervals (the arithmetic of
  the port's ``utils/profiling.py::busy_ms``, copied here so that the
  yardstick does not move with the program);
* ``kernel_times(pattern)``: the device durations of the kernels whose name
  holds ``pattern``;
* ``op_device_s(name)``: device time launched under CPU ops of that name
  (their kernels and their children's);
* ``breakdown()``: the ten device operations with the most time, and the
  longest idle gaps by what the host was doing (the benchmark's own span and
  the innermost operator running then).
"""

from __future__ import annotations

import bisect
import time
from collections import Counter

import torch

DEVICE = torch.autograd.DeviceType.CUDA
HOST = torch.autograd.DeviceType.CPU
SPAN_PREFIX = "portbench."


def span(name: str):
    """A host span of the benchmark's own, visible in the trace."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def warm_profiler():
    """Start and stop the profiler once on a small kernel: its first start
    (CUPTI's set-up) takes seconds, which would eat the traced sub-window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu").sum()
        _sync()


class SubWindow:
    """Call :meth:`at` with the seconds since the window opened, from the
    loop (or from a watcher while other threads work); the profiler starts
    at ``start_s`` and stops once it has run ``length_s`` (or when the
    window closes first)."""

    def __init__(self, enabled: bool, start_s: float, length_s: float):
        self.enabled, self.start_s, self.length_s = enabled, start_s, length_s
        self.prof = None
        self.t0 = self.t1 = None
        self.trace = None

    def at(self, elapsed: float):
        if not self.enabled or self.t1 is not None:
            return
        if self.prof is None and elapsed >= self.start_s:
            _sync()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.t0 is not None and time.perf_counter() - self.t0 >= self.length_s:
            self.close()

    def close(self):
        if self.prof is None or self.t1 is not None:
            return
        _sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def result(self):
        """The trace, reduced once the window has closed (the reduction
        takes seconds of host time, which would stall the work traced)."""
        if self.trace is None and self.t1 is not None:
            self.trace = Trace(self.prof.events(), self.t1 - self.t0)
            self.prof = None
        return self.trace

    def active(self, t0: float, t1: float) -> bool:
        """Whether the host interval [t0, t1] (perf_counter) lies inside the
        traced window."""
        return self.t0 is not None and self.t0 <= t0 and (self.t1 is None or t1 <= self.t1)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def union_s(spans) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + (cur_e - cur_s if cur_e is not None else 0.0)) / 1e6


class Trace:
    def __init__(self, events, window_s: float):
        self.window_s = window_s
        self.kernels = [e for e in events if e.device_type == DEVICE
                        and not e.name.startswith(SPAN_PREFIX)]  # not the spans' GPU copies
        self.host = [e for e in events if e.device_type == HOST and not e.is_async]
        self.busy_s = union_s((k.time_range.start, k.time_range.end) for k in self.kernels)

    def kernel_times(self, pattern: str) -> list:
        return [(k.time_range.end - k.time_range.start) / 1e6 for k in self.kernels
                if pattern in k.name]

    def op_device_s(self, name: str) -> float:
        return sum(e.device_time_total for e in self.host if e.name == name) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        ops: Counter = Counter()
        for k in self.kernels:
            ops[k.name] += (k.time_range.end - k.time_range.start) / 1e6
        gaps = self._gaps()
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}

    def _gaps(self, min_us: float = 50.0, scan_us: float = 5000.0) -> Counter:
        spans = sorted((k.time_range.start, k.time_range.end) for k in self.kernels)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        host = sorted(self.host, key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in host]
        ours = [e for e in host if e.name.startswith(SPAN_PREFIX)]
        out: Counter = Counter()
        for (_, a), (b, _) in zip(merged, merged[1:]):
            if b - a < min_us:
                continue
            mid = (a + b) / 2
            outer = [e.name[len(SPAN_PREFIX):] for e in ours
                     if e.time_range.start <= mid <= e.time_range.end]
            inner = "idle host"
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and starts[i] >= mid - scan_us:
                e = host[i]
                if e.time_range.end >= mid and not e.name.startswith(SPAN_PREFIX):
                    inner = e.name
                    break
                i -= 1
            out[f"{outer[-1] if outer else 'outside'}: {inner}"] += (b - a) / 1e6
        return out
