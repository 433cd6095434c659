"""Device milliseconds of the body model's forward kinematics (the bones
composed one after another) per batch: the mean ``device_time_total`` of
the program's ``multihmr.fk`` host spans."""

from portbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "fk")
