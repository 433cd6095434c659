"""Plain reference of Multi-HMR on DINOv2's ViT-g/14 backbone, one image at a time.

``reference/model.py``'s reference (the same detection, rays, HPH head and
body model, float32 by default with TF32 off on a card, the control one
precision step below) with the ViT block's FFN replaced by DINOv2's fused
SwiGLU (``dinov2/layers/swiglu_ffn.py::SwiGLUFFNFused``, the FFN of
``vit_giant2(ffn_layer="swiglufused")``), written from its equations:

    x12 = y W12^T + b12              W12: [2 H, D], H = (int(4 D * 2/3) + 7) // 8 * 8
    x1, x2 = x12[:H], x12[H:]        the first half is gated
    h = silu(x1) * x2                silu(a) = a * sigmoid(a) = a / (1 + exp(-a))
    out = h W3^T + b3                W3: [D, H], before the block's LayerScale ls2

Departures from DINOv2's module, each on purpose:

* ``SwiGLUFFNFused`` runs xformers' fused kernel where it is installed; this
  is the unfused ``SwiGLUFFN.forward`` it falls back to, the same sums;
* SiLU is written from its definition rather than ``F.silu``, so that the
  reference shares no kernel with the program's SwiGLU;
* under the control (``Precision(control=True)``) ``x12`` and ``h`` are
  stored in bfloat16 and both products take fp8 operands, as the GELU
  MLP's products do in ``reference/model.py``.

It reads its weights by the checkpoint's names (``mlp.w12``, ``mlp.w3``)
and imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference.model import Reference, layer_norm


def silu(a):
    return a / (1.0 + torch.exp(-a))


class VitgReference(Reference):
    """``Reference`` with the SwiGLU block; ``cfg``, ``w`` and ``body`` as there."""

    def _ffn(self, y, pre):
        P, w = self.P, self.w
        x12 = P.vit_linear(y, w[pre + "w12.weight"], w[pre + "w12.bias"])
        hidden = x12.shape[-1] // 2
        x1, x2 = x12[..., :hidden], x12[..., hidden:]
        h = P.vit_store(silu(x1) * x2)
        return P.vit_linear(h, w[pre + "w3.weight"], w[pre + "w3.bias"])

    def _block(self, x, i):
        P, w = self.P, self.w
        pre = f"backbone.blocks.{i}."
        y = P.vit_store(layer_norm(x, w[pre + "norm1.weight"], w[pre + "norm1.bias"], 1e-6))
        x = P.vit_store(x + self._attention(y, pre + "attn.") * w[pre + "ls1.gamma"])
        y = P.vit_store(layer_norm(x, w[pre + "norm2.weight"], w[pre + "norm2.bias"], 1e-6))
        return P.vit_store(x + self._ffn(y, pre + "mlp.") * w[pre + "ls2.gamma"])
