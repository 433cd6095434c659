"""K3 (``csrc/flash_bwd.cu``, the fused backward) in the training step: its
roofline bound at the cell's batch over its mean device time per call (%)."""

from portbench import roofline
from portbench.metrics._kernels import K3, roofline_pct


def read(ctx):
    return roofline_pct(ctx, K3, roofline.k3_bound_s)
