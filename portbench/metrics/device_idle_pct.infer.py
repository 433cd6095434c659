"""Device idle share of the traced sub-window (%), from the profiler's
kernel intervals."""

from portbench.metrics._idle import idle_pct as read  # noqa: F401
