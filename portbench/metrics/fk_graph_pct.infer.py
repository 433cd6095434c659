"""Share of the body model's forward-kinematics calls replayed from a CUDA
graph, in %: of the program's ``multihmr.fk`` host spans in the traced
sub-window, those that hold a ``cudaGraphLaunch`` runtime call. 0 where the
bones are launched one by one; None where the trace holds no ``fk`` span or
no device work (the CPU)."""

import bisect

from portbench.metrics._spans import PREFIX, _work

LAUNCH = "cudaGraphLaunch"  # the runtime call; some builds add a suffix (_ptsz)


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not _work(tr):
        return None
    spans = [e for e in tr.host if e.name == PREFIX + "fk"]
    if not spans:
        return None
    launches = sorted(e.time_range.start for e in tr.host if e.name.startswith(LAUNCH))
    held = 0
    for s in spans:
        i = bisect.bisect_left(launches, s.time_range.start)
        held += i < len(launches) and launches[i] <= s.time_range.end
    return 100.0 * held / len(spans)
