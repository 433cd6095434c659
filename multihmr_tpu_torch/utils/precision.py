"""Inference-time weight precision (``multihmr_tpu/utils/precision.py``).

The ViT computes in bf16; storing its matmul weights in bf16 once at load
time saves a cast per call and halves their memory. LayerNorm weights stay
fp32: they feed fp32 statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from multihmr_tpu_torch.models.vit import TLayerNorm


def cast_backbone_bf16(net: nn.Module) -> nn.Module:
    """Cast the ViT's parameters to bf16, except its LayerNorms: ``net.backbone``,
    or ``net.encoder.backbone`` in the Anny layout."""
    backbone = net.backbone if hasattr(net, "backbone") else net.encoder.backbone
    keep = {id(p) for m in backbone.modules()
            if isinstance(m, (TLayerNorm, nn.LayerNorm)) for p in m.parameters()}
    for p in backbone.parameters():
        if id(p) not in keep:
            p.data = p.data.to(torch.bfloat16)
    return net
