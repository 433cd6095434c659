"""Device-idle milliseconds per batch while the host was inside the
program's ``multihmr.readback`` span (waiting for the readback and building
the person lists)."""

from portbench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "readback")
