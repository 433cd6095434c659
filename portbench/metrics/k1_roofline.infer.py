"""K1 (``csrc/flash_fwd.cu``) in the batched forward: its roofline bound at
the cell's batch over its mean device time per call (%)."""

from portbench import roofline
from portbench.metrics._kernels import K1, roofline_pct


def read(ctx):
    return roofline_pct(ctx, K1, roofline.k1_bound_s)
