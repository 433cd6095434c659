"""K2 (``csrc/layernorm_cm.cu``: its kernel for D <= 1024 and its wide path
above) in the batched forward: its bytes bound at the cell's width, batch
and true tokens (``roofline_k2.py``) over its mean device time per call (%)."""

from portbench import roofline_k2
from portbench.metrics._kernels import roofline_pct

K2 = "layernorm_cm"  # both kernels' names hold it


def read(ctx):
    return roofline_pct(ctx, K2, roofline_k2.k2_bound_s)
