"""Host milliseconds of the body model's forward kinematics per batch: the
mean wall of the program's ``multihmr.fk`` host spans. The bones are
composed one after another, a few launches each, so this is the launch
time that a batched composition would cut."""

from portbench.metrics._spans import PREFIX


def read(ctx):
    tr = ctx["trace"]
    spans = [e for e in tr.host if e.name == PREFIX + "fk"] if tr is not None else []
    if not spans:
        return None
    return sum(e.time_range.end - e.time_range.start for e in spans) / len(spans) / 1e3
