"""Configurations the port runs beyond the JAX package's ``config.py``.

``config.py`` stays a field-for-field copy of the JAX package's. The
DINOv2 backbones that Multi-HMR's reference builds by name but the JAX
package never ported come in here, as ViT configs that ``ModelConfig``
takes through ``vit_override``:

  * ``dinov2_vitg14``: DINOv2's ViT-g/14 (``hubconf.dinov2_vitg14`` →
    ``vit_giant2(ffn_layer="swiglufused")``, arXiv:2304.07193): 40 blocks
    of width 1,536, 24 heads of 64, and a fused SwiGLU FFN of hidden width
    ``(int(6144 * 2 / 3) + 7) // 8 * 8 = 4096`` in place of the GELU MLP.

and the Multi-HMR configuration ``multiHMR_896_G`` (896 px, the HPH head of
``multiHMR_896_L``) on it. No released Multi-HMR checkpoint has this
backbone; the reference's ``Dinov2Backbone(name)`` builds it, and its
head's context width follows ``embed_dim``.

The port reads ViT configs by attribute: :func:`ffn_kind` and
:func:`ffn_hidden` give a config's FFN, "mlp" (GELU, ``fc1``/``fc2``) for
every config without an ``ffn_layer`` field, the JAX package's included.
"""

from __future__ import annotations

import dataclasses

from multihmr_tpu_torch.config import ModelConfig, ViTConfig

FFN_KINDS = ("mlp", "swiglufused")


@dataclasses.dataclass(frozen=True)
class PortViTConfig(ViTConfig):
    """A ViT config with DINOv2's ``ffn_layer`` choice."""

    ffn_layer: str = "mlp"

    def __post_init__(self):
        if self.ffn_layer not in FFN_KINDS:
            raise ValueError(f"unknown ffn_layer {self.ffn_layer!r}; known: {FFN_KINDS}")


def ffn_kind(vit) -> str:
    """"mlp" or "swiglufused"."""
    return getattr(vit, "ffn_layer", "mlp")


def ffn_hidden(vit) -> int:
    """The FFN's hidden width: ``embed_dim * mlp_ratio`` for the GELU MLP;
    for the SwiGLU two thirds of it rounded up to a multiple of 8
    (DINOv2's ``SwiGLUFFNFused``), the width of each of ``w12``'s halves."""
    hidden = int(vit.embed_dim * vit.mlp_ratio)
    if ffn_kind(vit) == "swiglufused":
        return (int(hidden * 2 / 3) + 7) // 8 * 8
    return hidden


VITG = PortViTConfig(embed_dim=1536, depth=40, num_heads=24, ffn_layer="swiglufused")

BACKBONES = {"dinov2_vitg14": VITG}

CONFIGS = {
    "multiHMR_896_G": ModelConfig(backbone="dinov2_vitg14", img_size=896, vit_override=VITG),
}
