"""Device milliseconds of the SMPL-X body model over all B x K slots per
batch: the mean ``device_time_total`` of the program's ``multihmr.body``
host spans."""

from portbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "body")
