"""The Anny family's batched forward, its model FLOPs per second over the
bf16 peak (%): images finished inside the traced sub-window times one
image's forward FLOPs (``roofline_anny.forward_flops``, the body model left
out), over the sub-window's wall."""

from portbench import roofline_anny
from portbench.metrics._kernels import mfu_pct


def read(ctx):
    return mfu_pct(ctx, roofline_anny.forward_flops(ctx["cell"].config),
                   getattr(ctx["state"], "traced_units", 0))
