"""Device-idle milliseconds per batch while the host was inside the
program's ``multihmr.upload`` span (the host-to-device copy of the
batch)."""

from portbench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "upload")
