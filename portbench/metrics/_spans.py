"""Per-batch readings of the program's own spans in a traced sub-window.

The program opens host ranges named ``multihmr.<name>`` around the stages
of a batch (``multihmr_tpu_torch/utils/profiling.py::span``), flat and in
this order: ``stack``, ``upload``, ``vit``, ``head``, ``body``,
``readback``. The names are held here as strings: the yardstick imports
nothing of the program. A trace of a program without these spans gives
``None`` for every reading.

* :func:`stage_ms`: the mean ``device_time_total`` of a stage's host
  spans, the device time of the kernels and copies launched under them.
* :func:`idle_ms`: device-idle milliseconds per batch while the host was
  inside one of the host phases ``stack``, ``upload`` and ``readback``, or
  (``phase=None``) under none of them.

"Per batch" is per ``multihmr.vit`` host span; the profiler records only
inside the sub-window, so each one started there. Every reading is ``None``
when the trace holds no device work (the CPU).

Device-idle is the complement of the merged intervals of the trace's
device events (kernels, copies, memsets), taken between the earliest start
and the latest end of all of the trace's events. Device events named
``multihmr.`` or ``portbench.``, and user annotations, are left out of the
intervals: they are the profiler's device copies of host ranges, not work.
Each idle interval is split by its overlap with the host phases' spans,
with no limit on how long before the gap a span started. The spans are
flat, so the three phases never overlap, and the four idle readings add up
to the sub-window's idle time per batch: (window - busy) / batches, with
window and busy as defined here.
"""

from __future__ import annotations

PREFIX = "multihmr."
COPIES = (PREFIX, "portbench.")  # names of host ranges' device copies
HOST_PHASES = ("stack", "upload", "readback")


def _spans(tr, name: str) -> list:
    return [e for e in tr.host if e.name == PREFIX + name]


def _work(tr) -> list:
    return [e for e in tr.kernels
            if not e.name.startswith(COPIES) and not getattr(e, "is_user_annotation", False)]


def merged(intervals) -> list:
    """Sorted, disjoint [start, end] lists covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _ranges(events) -> list:
    return merged((e.time_range.start, e.time_range.end) for e in events)


def idle_intervals(tr) -> list:
    """The device's idle intervals (us), or ``None`` without device work."""
    work = _work(tr) if tr is not None else []
    if not work:
        return None
    every = tr.kernels + tr.host
    lo = min(e.time_range.start for e in every)
    hi = max(e.time_range.end for e in every)
    idle, cur = [], lo
    for s, e in _ranges(work):
        if s > cur:
            idle.append([cur, s])
        cur = max(cur, e)
    if hi > cur:
        idle.append([cur, hi])
    return idle


def stage_ms(ctx, name: str):
    """Mean device milliseconds under the host spans ``multihmr.<name>``."""
    tr = ctx["trace"]
    if tr is None or not _work(tr):
        return None
    spans = _spans(tr, name)
    if not spans:
        return None
    return sum(e.device_time_total for e in spans) / len(spans) / 1e3


def idle_ms(ctx, phase):
    """Device-idle milliseconds per batch inside the host phase ``phase``'s
    spans, or (``None``) outside all of :data:`HOST_PHASES`' spans."""
    tr = ctx["trace"]
    idle = idle_intervals(tr)
    batches = len(_spans(tr, "vit")) if idle is not None else 0
    if not batches:
        return None
    if phase is None:
        covered = _ranges(e for p in HOST_PHASES for e in _spans(tr, p))
        us = sum(e - s for s, e in idle) - overlap(idle, covered)
    else:
        us = overlap(idle, _ranges(_spans(tr, phase)))
    return us / batches / 1e3
