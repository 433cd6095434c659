"""Model configuration (``multihmr_tpu/config.py``).

The port's own copy of the JAX package's dataclasses, field for field, so
that the port imports nothing of ``multihmr_tpu``. ``tests/test_torch_config.py``
holds the copy equal to the original. The port reads configs by attribute
only and never checks their type, so any object with these fields works.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """DINOv2-geometry ViT."""

    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 14
    mlp_ratio: float = 4.0
    # DINOv2 specifics
    layerscale_init: float = 1.0e-5
    pos_embed_size: int = 37  # 518 / 14 pretraining grid
    qkv_bias: bool = True
    ffn_bias: bool = True
    proj_bias: bool = True

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


VITS = ViTConfig(embed_dim=384, depth=12, num_heads=6)
VITB = ViTConfig(embed_dim=768, depth=12, num_heads=12)
VITL = ViTConfig(embed_dim=1024, depth=24, num_heads=16)

_BACKBONES = {
    "dinov2_vits14": VITS,
    "dinov2_vitb14": VITB,
    "dinov2_vitl14": VITL,
}


@dataclasses.dataclass(frozen=True)
class HPHConfig:
    """Cross-attention SMPL decoder head."""

    dim: int = 1024
    depth: int = 2
    heads: int = 8
    dim_head: int = 32
    mlp_dim: int = 1024


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full Multi-HMR model configuration (SMPL-X variant).

    ``max_people`` is the static detection capacity. ``remat`` with
    ``remat_policy`` "block" recomputes each whole ViT block in the backward
    pass (the flash-attention forward runs twice); "mlp" recomputes only the
    block's MLP.
    """

    backbone: str = "dinov2_vitb14"
    img_size: int = 896
    # Camera-ray Fourier embedding
    camera_embedding_num_bands: int = 16
    camera_embedding_max_resolution: int = 64
    nearness: bool = True  # regress log-depth
    clip_dist: bool = True
    fovn: int = 60
    # Head
    xat_depth: int = 2
    xat_num_heads: int = 8
    person_center: Optional[str] = "head"
    num_betas: int = 10
    nrot: int = 53  # SMPL-X: global + 21 body + 15+15 hands + jaw
    # static detection capacity
    max_people: int = 16
    # Numerics
    compute_dtype: str = "bfloat16"  # matmul/activation dtype inside the ViT
    param_dtype: str = "float32"
    # Training memory: recompute ViT activations in the backward pass
    remat: bool = False
    remat_policy: str = "block"
    # Testing/bench hook: replace the named backbone geometry with a custom one
    vit_override: Optional[ViTConfig] = None

    @property
    def vit(self) -> ViTConfig:
        if self.vit_override is not None:
            return self.vit_override
        return _BACKBONES[self.backbone]

    @property
    def patch_size(self) -> int:
        return self.vit.patch_size

    @property
    def grid_size(self) -> int:
        assert self.img_size % self.patch_size == 0, "Invalid img size"
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def camera_embed_dim(self) -> int:
        # identity(3) + sin/cos per band per xyz dim
        return 3 + 2 * 3 * self.camera_embedding_num_bands

    @property
    def hph(self) -> HPHConfig:
        return HPHConfig(depth=self.xat_depth, heads=self.xat_num_heads)

    @property
    def npose(self) -> int:
        return 6 * self.nrot  # 6d rotation per joint

    @property
    def token_dim(self) -> int:
        # query token = central feature (+ ray) ++ init pose/betas/cam
        context_dim = self.vit.embed_dim + self.camera_embed_dim
        return self.npose + self.num_betas + 3 + context_dim


# Named configurations matching the published checkpoints.
def named_config(name: str) -> ModelConfig:
    table = {
        "multiHMR_896_L": ModelConfig(backbone="dinov2_vitl14", img_size=896),
        "multiHMR_672_L": ModelConfig(backbone="dinov2_vitl14", img_size=672),
        "multiHMR_672_B": ModelConfig(backbone="dinov2_vitb14", img_size=672),
        "multiHMR_672_S": ModelConfig(backbone="dinov2_vits14", img_size=672),
        "multiHMR_1288_L_bedlam": ModelConfig(backbone="dinov2_vitl14", img_size=1288),
        "multiHMR_1288_L_agora": ModelConfig(backbone="dinov2_vitl14", img_size=1288),
    }
    if name not in table:
        raise KeyError(f"Unknown model name {name!r}; known: {sorted(table)}")
    return table[name]
