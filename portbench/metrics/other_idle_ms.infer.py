"""Device-idle milliseconds per batch while the host was inside none of the
program's ``multihmr.stack``, ``multihmr.upload`` and ``multihmr.readback``
spans (the caller's own Python, the forward's dispatch, the readback's
enqueue)."""

from portbench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, None)
