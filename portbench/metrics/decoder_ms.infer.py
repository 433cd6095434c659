"""Device milliseconds of the Anny family's decoder (masked self-attention,
cross-attention over every cell and the MLP, ``xat_depth`` layers) per
batch: the mean ``device_time_total`` of the program's ``multihmr.decoder``
host spans."""

from portbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "decoder")
