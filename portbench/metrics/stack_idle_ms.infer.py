"""Device-idle milliseconds per batch while the host was inside the
program's ``multihmr.stack`` span (stacking the batch's images and K on the
host)."""

from portbench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "stack")
