"""Model FLOPs of the Anny family's forward (``multiHMR_672_L_anny``).

Operations count what the algorithm needs, as ``roofline.py`` counts them:
two a multiply-add of every matrix product, on the true token count
(``1 + g*g``) and on every one of the ``max_people`` person slots that the
program computes. The body model is left out, as ``roofline.forward_flops``
leaves out SMPL-X's.
"""

from __future__ import annotations

from portbench import roofline


def forward_flops(cfg: dict) -> float:
    """One image's forward: the ViT's linear layers and attention and its
    patch embedding; the detection MLP over every cell and the FOV MLP on
    the class token; ``dec_to_token`` over every cell; the decoder's
    ``xat_depth`` layers over ``k`` slots (self-attention's q/k/v, scores,
    values and output; cross-attention's q, its k/v projection over the
    ``g*g`` context, scores, values and output; the MLP); and the offset,
    pose, phenotype and distance heads."""
    n, D, L = roofline.tokens(cfg), cfg["embed_dim"], cfg["depth"]
    p, g = cfg["patch_size"], cfg["img_size"] // cfg["patch_size"]
    hidden = int(D * cfg["mlp_ratio"])
    vit = L * (2 * n * D * (4 * D + 2 * hidden) + 4 * n * n * D) + 2 * (n - 1) * p * p * 3 * D
    enc = 2 * (g * g) * (D * D + D) + 2 * (D * D + D)
    k, X, M = cfg["max_people"], cfg["xat_dim"], cfg["xat_mlp_dim"]
    inner = cfg["xat_heads"] * cfg["xat_dim_head"]
    per_layer = (2 * k * X * 3 * inner + 4 * k * k * inner + 2 * k * inner * X  # self
                 + 2 * k * X * inner + 2 * g * g * X * 2 * inner  # cross: q, k/v
                 + 4 * k * g * g * inner + 2 * k * inner * X  # cross: scores, values, out
                 + 4 * k * X * M)  # MLP
    pose = 6 * cfg["n_joints"]
    heads = 2 * k * (4 * X * X + X * 2 + pose * X + X * pose + X * cfg["num_betas"] + X)
    dec = 2 * (g * g) * D * X + cfg["xat_depth"] * per_layer + heads
    return float(vit + enc + dec)
