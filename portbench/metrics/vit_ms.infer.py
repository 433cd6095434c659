"""Device milliseconds of the ViT (the backbone) per batch: the mean
``device_time_total`` of the program's ``multihmr.vit`` host spans."""

from portbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "vit")
