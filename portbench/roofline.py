"""Peaks of the card and the work of the kernels and of a whole step.

The peaks are NVIDIA's published H100 SXM figures (dense bf16 tensor-core
rate, HBM3 bandwidth) at its full 700 W; a run prints the card's power
limit beside every share. Operations and bytes count what the algorithm
needs on the true token count (1 + g*g), each input read once and each
output written once.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM


def bound_s(flops: float, nbytes: float) -> float:
    """Least time for the work: the larger of operations over the peak rate
    and bytes over the memory rate."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def tokens(cfg: dict) -> int:
    g = cfg["img_size"] // cfg["patch_size"]
    return 1 + g * g


def k1_bound_s(cfg: dict, batch: int) -> float:
    """K1, the channels-major flash forward: QK^T and PV over every head,
    ``4 B H N^2 d``; bf16 q, k, v in and the output out, fp32 lse out."""
    n, h, d = tokens(cfg), cfg["num_heads"], cfg["embed_dim"] // cfg["num_heads"]
    return bound_s(4 * batch * h * n * n * d, 4 * batch * h * d * n * 2 + batch * h * n * 4)


def k3_bound_s(cfg: dict, batch: int) -> float:
    """K3, the fused flash backward: five ``N x N x d`` products (S, dP, dV,
    dK, dQ), ``10 B H N^2 d``; q, k, v, o, dO in and dq, dk, dv out in bf16,
    lse in fp32."""
    n, h, d = tokens(cfg), cfg["num_heads"], cfg["embed_dim"] // cfg["num_heads"]
    return bound_s(10 * batch * h * n * n * d, 8 * batch * h * d * n * 2 + batch * h * n * 4)


def forward_flops(cfg: dict) -> float:
    """Model FLOPs of one image's forward: the ViT's linear layers
    (``2 N D (3D + D + 2 * mlp_ratio * D)`` a block, plus the patch
    embedding) and attention (``4 N^2 D`` a block), the score and offset
    MLPs over every cell, and the head: the persons' self-attention, their
    cross-attention over the ``g*g`` context, its K/V projection, and the
    MLPs and decoders."""
    n, D, L = tokens(cfg), cfg["embed_dim"], cfg["depth"]
    p, g = cfg["patch_size"], cfg["img_size"] // cfg["patch_size"]
    hidden = int(D * cfg["mlp_ratio"])
    vit = L * (2 * n * D * (4 * D + 2 * hidden) + 4 * n * n * D) + 2 * (n - 1) * p * p * 3 * D
    mlps = 2 * (g * g) * (D * D + D) + 2 * (g * g) * (D * D + 2 * D)
    k, hd, inner = cfg["max_people"], cfg["hph_dim"], 256
    ctx = D + 3 + 6 * cfg["camera_embedding_num_bands"]
    tok = 6 * cfg["nrot"] + cfg["num_betas"] + 3 + ctx
    per_layer = (2 * k * hd * 3 * inner + 4 * k * k * inner + 2 * k * inner * hd  # self
                 + 2 * k * hd * inner + 2 * g * g * ctx * 2 * inner  # cross: q, k/v
                 + 4 * k * g * g * inner + 2 * k * inner * hd  # cross: scores, values, out
                 + 4 * k * hd * hd)  # MLP
    dec = 2 * k * hd * (6 * cfg["nrot"] + cfg["num_betas"] + 3 + 10)
    head = 2 * k * tok * hd + cfg["xat_depth"] * per_layer + dec
    return float(vit + mlps + head)


def step_flops(cfg: dict, batch: int) -> float:
    """A training step: forward and backward, three times the forward."""
    return 3.0 * batch * forward_flops(cfg)
