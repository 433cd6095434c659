"""The work of K2, the channels-major LayerNorm (``csrc/layernorm_cm.cu``).

Counted as ``roofline.py`` counts K1: on the true token count (``1 + g*g``)
at the cell's batch and width D, each input read once and each output
written once: the bf16 stream in and the bf16 normalized stream out, and
the fp32 scale and bias. About 8 operations an element (two sums, the
centring, the square, the scale and the affine) leave it bound by bytes.
"""

from __future__ import annotations

from portbench import roofline


def k2_bound_s(cfg: dict, batch: int) -> float:
    """Least time of one K2 call on ``[batch, D, tokens]`` bf16 in and out."""
    n, D = roofline.tokens(cfg), cfg["embed_dim"]
    return roofline.bound_s(8 * batch * D * n, 2 * batch * D * n * 2 + 2 * D * 4)
