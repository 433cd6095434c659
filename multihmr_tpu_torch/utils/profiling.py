"""Profiling and timing utilities (``multihmr_tpu/utils/profiling.py``).

The one timing path of the port: the tools (``profile_model``,
``sweep_capacity``, ``train_smoke``, ``kernel_timing``) time through here.

  * :class:`Timer`: wall-clock spans with p50/p90 summaries (the JAX one);
  * :func:`span`: a named range of the program's own in a profiler trace
    (``multihmr.<name>``), at the boundaries of the folder path and of the
    forward's stages;
  * :func:`profile_trace`: ``torch.profiler`` over the CPU and, where there
    is one, the card, written as a Chrome trace (Perfetto opens it);
  * :func:`device_op_table`: a trace's device time per kernel;
  * :func:`busy_ms` and :func:`profile_steps`: the device's busy time (the
    union of its kernels' intervals) and the kernels with the most time;
  * :func:`cuda_ms`: CUDA events around back-to-back calls of one kernel;
  * :func:`latency_stats`: the per-call slope of chains of dependent calls.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import subprocess
import tempfile
import time
from collections import Counter
from typing import Callable, Dict, List

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast


class Timer:
    def __init__(self, name: str = "timer"):
        self.name = name
        self.spans: List[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        arr = np.asarray(self.spans)
        if arr.size == 0:
            return {}
        return {
            "n": int(arr.size),
            "p50_ms": float(1e3 * np.median(arr)),
            "p90_ms": float(1e3 * np.percentile(arr, 90)),
            "mean_ms": float(1e3 * arr.mean()),
        }

    def __str__(self):
        s = self.summary()
        return f"{self.name}: " + ", ".join(f"{k}={v:.3g}" for k, v in s.items())


SPAN_PREFIX = "multihmr."


def span(name: str):
    """A host range ``multihmr.<name>`` in a ``torch.profiler`` trace around
    the block: the operators the block runs are its ``cpu_children``, and its
    ``device_time_total`` the time of the kernels they launch.

    ``torch.profiler.record_function`` would open a user annotation, which
    the profiler copies onto the device timeline (a range from the first
    kernel under it to the last, which a trace reader counts as device work).
    This range has no such copy, costs about a microsecond with the profiler
    off, and puts no node into a ``torch.export`` graph."""
    return _RecordFunctionFast(SPAN_PREFIX + name)


def device_line(device) -> str:
    """What the numbers were taken on: on a card, nvidia-smi's
    ``name, power.limit``; on the CPU, "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile_trace(logdir: str = os.path.join(tempfile.gettempdir(), "multihmr_torch_trace")):
    """``torch.profiler`` over the block (the CPU, and the card where there
    is one); yields the profiler, and at the end writes its Chrome trace
    ``trace_<ns>.json`` into ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def _load_trace(logdir_or_trace: str) -> dict:
    path = logdir_or_trace
    if os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, "*.json")) + glob.glob(os.path.join(
            path, "*.json.gz")), key=os.path.getmtime)
        if not paths:
            raise FileNotFoundError(f"no trace .json under {path}")
        path = paths[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def device_op_table(logdir_or_trace: str, top: int = 25, runs: int = 1):
    """The newest Chrome trace under ``logdir_or_trace`` (or that trace
    file) as a per-op device-time table: a list of (name, ms_per_run,
    count_per_run), sorted by time. ``runs``: how many profiled executions
    the trace holds (totals are divided by it). Device events are the trace's
    CUDA kernels (category "kernel"); a trace without any (the CPU) counts
    every complete event instead, as the JAX function does."""
    events = [e for e in _load_trace(logdir_or_trace).get("traceEvents", [])
              if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    durs: Counter = Counter()
    counts: Counter = Counter()
    for e in kernels or events:
        durs[e["name"]] += e.get("dur", 0)
        counts[e["name"]] += 1
    return [(name, d / runs / 1e3, counts[name] // max(runs, 1))
            for name, d in durs.most_common(top)]


def busy_ms(events) -> float:
    """Union of the device kernels' [start, end) intervals among profiler
    events (``prof.events()``), in milliseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + (cur_e - cur_s if cur_e is not None else 0.0)) / 1e3


def profile_steps(step, batch, top: int, log=print, steps: int = 2) -> dict:
    """``torch.profiler`` over ``steps`` calls of ``step(batch, 0)``: the wall
    per call (host clock, ending in a synchronize), the device's busy time
    per call and its share, and the ``top`` kernels with the most device
    time per call. Returns {"wall_ms", "busy_ms"}."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch, 0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    busy = busy_ms(prof.events()) / steps
    log(f"profiled: wall {wall:.1f} ms/step, device busy {busy:.1f} ms/step "
        f"({100 * busy / wall:.1f} %)")
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log(f"{'ms/step':>9} {'calls/step':>10}  kernel")
    for e in rows[:top]:
        log(f"{e.self_device_time_total / 1e3 / steps:9.3f} {e.count / steps:10.1f}  "
            f"{e.key[:100]}")
    return {"wall_ms": wall, "busy_ms": busy}


def cuda_ms(fn, iters: int, reps: int = 5, warmup: int = 3, ahead_ms: float = 0.0) -> float:
    """Milliseconds per ``fn()``: CUDA events around ``iters`` back-to-back
    calls (so host launch overhead hides behind queued device work), the
    median of ``reps`` such runs. ``ahead_ms``: the device first spins that
    long, so that the host queues the calls ahead of it; for kernels shorter
    than their launch's host cost, whose back-to-back calls would otherwise
    time the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if ahead_ms:
            torch.cuda._sleep(int(ahead_ms * 2e6))  # ~2e6 cycles per ms at up to 1.98 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def tensor_leaves(tree) -> list:
    """The tensors of a nest of dicts, lists and tuples (NamedTuples too)."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in tensor_leaves(sub)]
    return []


def latency_stats(
    fn: Callable, args: tuple, iters: int = 8, repeats: int = 5,
    on_pair: Callable = None,
) -> Dict[str, float]:
    """Per-call latency of ``fn(*args)`` (tensors in, a nest of tensors out)
    as the slope of two chains of dependent calls, n = ``iters`` and
    n = 2·``iters``, timed back to back: (t_long − t_short) / iters, whose
    constant (the first call's queueing, the final wait) cancels.

    Each call's input depends on the previous outputs: the last
    floating-point tensor in ``args`` is perturbed by ``acc * 1e-12``, where
    ``acc`` is a device scalar that sums every output of the chain so far.
    Nothing inside a chain waits for the device. So pass the input that the
    timed work consumes last among the floats (a forward's image: close
    over ``K``). Calls run under ``torch.inference_mode``.

    On a card each chain is timed with CUDA events after a synchronize, on
    the CPU with the host clock. The slope is the per-call time of
    back-to-back eager calls: where the host's dispatch of one call takes
    longer than the device's work (a batch-1 forward, whose device busy
    time is a fraction of its wall), the device waits for the host and the
    slope is the host's pace, not the device time; ``profile_model --ops``
    reads the device time separately.

    ``on_pair(p50_ms_so_far)``: called once, after the 3rd slope pair."""
    perturb_idx = max(i for i, a in enumerate(args)
                      if torch.is_tensor(a) and a.is_floating_point())
    device = args[perturb_idx].device
    on_card = device.type == "cuda"

    def chain(n):
        acc = torch.zeros((), dtype=torch.float32, device=device)
        with torch.inference_mode():
            for _ in range(n):
                cur = list(args)
                cur[perturb_idx] = cur[perturb_idx] + acc * 1e-12
                for leaf in tensor_leaves(fn(*cur)):
                    acc = acc + leaf.float().sum()
        return acc

    def timed(n):
        if on_card:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        float(chain(n))
        return time.perf_counter() - t0

    for _ in range(2):  # warm-up: the first calls pay one-off costs
        timed(2 * iters)
    slopes = []
    for r in range(repeats):
        t_short = timed(iters)
        t_long = timed(2 * iters)
        slopes.append((t_long - t_short) / iters)
        if r == 2 and on_pair is not None:
            on_pair(float(1e3 * max(np.median(slopes), 1e-6)))
    # clamp: a slope can go <= 0 where noise dominates a short chain
    return {
        "p50_ms": float(1e3 * max(np.median(slopes), 1e-6)),
        "min_ms": float(1e3 * max(min(slopes), 1e-6)),
        "iters": iters,
    }
