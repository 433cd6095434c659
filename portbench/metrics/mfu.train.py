"""The training step's model FLOPs per second over the bf16 peak (%): steps
finished inside the traced sub-window times three forwards of the batch
(``roofline.step_flops``), over the sub-window's wall."""

from portbench import roofline
from portbench.metrics._kernels import mfu_pct


def read(ctx):
    cell = ctx["cell"]
    return mfu_pct(ctx, roofline.step_flops(cell.config, cell.traffic["batch"]),
                   getattr(ctx["state"], "traced_units", 0))
