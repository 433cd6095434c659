"""The batched forward's model FLOPs per second over the bf16 peak (%):
images finished inside the traced sub-window times one image's forward
FLOPs (``roofline.forward_flops``), over the sub-window's wall."""

from portbench import roofline
from portbench.metrics._kernels import mfu_pct


def read(ctx):
    return mfu_pct(ctx, roofline.forward_flops(ctx["cell"].config),
                    getattr(ctx["state"], "traced_units", 0))
