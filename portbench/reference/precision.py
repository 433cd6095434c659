"""The reference's arithmetic: plain float32, or the control.

``Precision(control=False)`` is the reference itself: every product and
every element in float32, no TF32 (the caller turns TF32 off on a card).

``Precision(control=True)`` is the same mathematics one precision step
below what the configuration states, the step a later change could be
tempted to take: the ViT, which the configuration computes in bfloat16,
takes its matrix products in fp8 (e4m3, one scale per tensor, as a
per-tensor-scaled fp8 GEMM does) and keeps its stream in bfloat16; the
detection head, the regression head, the geometry and the body model,
which it computes in float32 with TF32 off, take their products with TF32
operands (10 mantissa bits). A sound comparison has to fail it.

Rounding passes its gradient straight through (``x + (q(x) - x).detach()``),
so the control trains too.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _straight(x, q):
    return x + (q - x).detach() if x.requires_grad else q


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """fp8 e4m3 with one scale for the whole tensor (its absolute maximum
    mapped to the format's largest value)."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return _straight(x, q)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest at TF32's 10 mantissa bits."""
    xd = x.detach().float().contiguous()
    bits = xd.view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return _straight(x, bits.view(torch.float32).to(x.dtype))


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return _straight(x, x.detach().to(torch.bfloat16).to(x.dtype))


class Precision:
    def __init__(self, control: bool = False):
        self.control = control

    # ViT: stated bfloat16 products (the control: fp8)
    def vit_linear(self, x, w, b=None):
        if self.control:
            x, w = round_fp8(x), round_fp8(w)
        y = x @ w.transpose(-1, -2)
        if b is not None:
            y = y + b
        return self.vit_store(y)

    def vit_store(self, x):
        return round_bf16(x) if self.control else x

    def vit_operand(self, x):
        return round_fp8(x) if self.control else x

    # everything else: stated float32 with TF32 off (the control: TF32)
    def operand(self, x):
        return round_tf32(x) if self.control else x

    def linear(self, x, w, b=None):
        y = self.operand(x) @ self.operand(w).transpose(-1, -2)
        return y if b is None else y + b

    def einsum(self, eq, *ops):
        return torch.einsum(eq, *(self.operand(o) for o in ops))
