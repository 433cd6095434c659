"""Device milliseconds of the ViT's SwiGLU FFNs per batch: the device time
of the kernels launched under the program's ``multihmr.ffn`` host spans
(one a block, nested in ``multihmr.vit``), over the ``multihmr.vit`` spans
(one a batch). ``None`` where the program opens no such span (a GELU
backbone, or a program without the span) or the trace holds no device work.

Each kernel is counted once. The profiler links a kernel to the host event
whose correlation id (``id``) launched it, and lists it in that event's
``kernels``; every host event that lies inside an ``ffn`` span on the
span's thread gives its kernels once per id. A span's
``device_time_total`` (``_spans.stage_ms``) sums the same lists down the
tree of children, and an id that two nested host events share is counted
there twice. The profiler's device copies of host ranges (named
``multihmr.`` or ``portbench.``) are not work and are left out.
"""

import bisect

from portbench.metrics._spans import COPIES, PREFIX, _spans, _work


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not _work(tr):
        return None
    spans = sorted(_spans(tr, "ffn"), key=lambda e: e.time_range.start)
    batches = len(_spans(tr, "vit"))
    if not spans or not batches:
        return None
    starts = [e.time_range.start for e in spans]
    us = {}
    for e in tr.host:
        if not e.kernels or e.name.startswith(PREFIX) or e.id in us:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i < 0:
            continue
        s = spans[i]  # the spans are flat among themselves: the last to start holds e, or none
        if s.thread == e.thread and e.time_range.end <= s.time_range.end:
            us[e.id] = sum(k.duration for k in e.kernels if not k.name.startswith(COPIES))
    return sum(us.values()) / batches / 1e3
