"""Device milliseconds of the head (detection, rays, HPH, the camera's undo)
per batch: the mean ``device_time_total`` of the program's ``multihmr.head``
host spans."""

from portbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "head")
