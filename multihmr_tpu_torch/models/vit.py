"""DINOv2-geometry ViT (``multihmr_tpu/models/vit.py``), on either of the JAX
package's two residual streams, picked by ``tp_mode`` alone: the JAX rule
``transposed = transposed_stream and tp_mode != "ring"`` with its
``transposed_stream`` at its default (True), which nothing in either package
changes outside tests.

  * channels-major (``TBlock``, the default): the stream runs as
    ``[B, D, N]`` through the blocks. The qkv projection then yields q, k
    and v as ``[B, H, Dh, N]`` views with no copy, the operand layout of the
    flash kernel K1 (ops/attention.py), and the block LayerNorms reduce over
    the channel dim with K2 (ops/norm.py): K1 once and K2 twice per block.
    Dense layers are plain ``torch.baddbmm``. The stream is pre-padded once
    with zero tokens to ``padded_len`` (a multiple of 8: 2,312, 4,104
    and 8,472 tokens at 672, 896 and 1288 pixels), so that every channel
    row starts 16-byte aligned: the GEMMs get cuBLAS's aligned kernels and
    K1/K3 their 16-byte asynchronous copies. ``kv_len`` (the true token
    count) goes down to the attention, which masks keys at or past it; all
    else is per token, so the pad tokens (finite: LayerNorm of a zero token
    is its bias) never reach a real one, and the pad is dropped before the
    final norm.
  * standard (``Block``, ``tp_mode="ring"``): the stream runs as
    ``[B, N, D]``. The qkv projection is reshaped to a packed
    ``[B, N, 3, H, Dh]`` whose slices are K5's operands, K5 writes the
    heads-merged ``[B, N, D]`` the output projection reads, and the block
    LayerNorms are plain fp32 ``F.layer_norm`` followed by a cast, as the
    JAX ``Block`` has them: K5 once per block, no K1 and no K2. Dense layers
    are ``F.linear``. ``tp_mode`` only picks the stream here: there is no
    mesh, so "ring" runs no ring.

Both streams have the same parameter names (those of the reference
checkpoints) and draw the same seeded init in the same order.

Precision follows the JAX package: matmuls and the stream in
``dtype`` (bf16 by default), LayerNorm statistics in fp32, GELU exact (erf)
in fp32 and tanh-approximate in bf16, and an fp32 final LayerNorm.
The JAX stream pre-pad (``models/vit.py:378-398, 414-415``) is ported at
the port's own length: the JAX length ``transposed_padded_len`` and its 5 %
overhead gate are TPU tiling and are not ported.

Training: the attention backward is K3 (the standard stream copies into its
channels-major layout) and the LayerNorm backward analytic torch ops.
``remat_policy`` "block" recomputes each whole block in the backward pass (the
forward kernels run twice per block and step), "mlp" only the block's MLP
(``torch.utils.checkpoint``, non-reentrant), as ``models/vit.py:290-312`` of
the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multihmr_tpu_torch.config import ViTConfig
from multihmr_tpu_torch.ops.attention import attention_qkv, flash_attention_qkv_t, padded_len
from multihmr_tpu_torch.ops.norm import layernorm_cm


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal fan-in init (flax ``lecun_normal``) of a weight stored
    ``[out, in]``."""
    std = math.sqrt(1.0 / w.shape[-1]) / 0.87962566103423978  # truncation at ±2
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
        w.mul_(std)
    return w


def _gelu(x):
    # exact in fp32, tanh-approximate in bf16 (as the JAX package)
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class TLinear(nn.Module):
    """Dense layer on ``[B, in, N]`` → ``[B, out, N]``; weight ``[out, in]``."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.empty(fan_out))

    def forward(self, x):
        # baddbmm writes [B, out, N] directly; torch.matmul(w, x) would fold
        # to (x^T w^T)^T and pay a transpose copy of every output
        B = x.shape[0]
        w = self.weight.to(x.dtype).expand(B, -1, -1)
        return torch.baddbmm(self.bias.to(x.dtype)[:, None], w, x)


class TLayerNorm(nn.Module):
    """LayerNorm over the channel dim of ``[B, D, N]`` (kernel K2 on CUDA)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, out_dtype):
        return layernorm_cm(x, self.weight, self.bias, self.eps, out_dtype)


class TLayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)[None, :, None]


class TAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = TLinear(dim, 3 * dim)
        self.proj = TLinear(dim, dim)

    def forward(self, x, kv_len=None):  # [B, D, N]; tokens >= kv_len are pad
        B, D, N = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(B, 3, h, D // h, N)  # a view: token dim untouched
        out = flash_attention_qkv_t(qkv, kv_len=kv_len)  # [B, h, Dh, N]
        return self.proj(out.reshape(B, D, N))


class TMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = TLinear(dim, hidden)
        self.fc2 = TLinear(hidden, dim)

    def forward(self, x):
        return self.fc2(_gelu(self.fc1(x)))


class TBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, remat_mlp: bool = False):
        super().__init__()
        self.remat_mlp = remat_mlp
        d = cfg.embed_dim
        self.norm1 = TLayerNorm(d)
        self.attn = TAttention(d, cfg.num_heads)
        self.ls1 = TLayerScale(d, cfg.layerscale_init)
        self.norm2 = TLayerNorm(d)
        self.mlp = TMlp(d, int(d * cfg.mlp_ratio))
        self.ls2 = TLayerScale(d, cfg.layerscale_init)

    def forward(self, x, kv_len=None):
        # one expression per branch: each temporary is freed as soon as it
        # is consumed, so the allocator reuses its block for the next one
        x = x + self.ls1(self.attn(self.norm1(x, x.dtype), kv_len))
        return x + self.ls2(self._mlp(self.norm2(x, x.dtype)))

    def _mlp(self, y):
        return _maybe_checkpoint(self.mlp, y) if self.remat_mlp else self.mlp(y)


# ---------------------------------------------------------------------------
# Standard stream: [B, N, D]


def _dense(layer: nn.Linear, x):
    dt = x.dtype
    return F.linear(x, layer.weight.to(dt), layer.bias.to(dt))


def _layer_norm(norm: nn.LayerNorm, x):
    """fp32 statistics and affine, cast back to x's dtype (the JAX ``Block``'s
    ``nn.LayerNorm(dtype=float32)`` then ``astype``)."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                     norm.bias.float(), norm.eps)
    return y.to(x.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):  # [B, N, D]
        B, N, D = x.shape
        h = self.num_heads
        qkv = _dense(self.qkv, x).reshape(B, N, 3, h, D // h)  # a view
        return _dense(self.proj, attention_qkv(qkv))  # [B, N, D] heads-merged


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return _dense(self.fc2, _gelu(_dense(self.fc1, x)))


class Block(nn.Module):
    """Standard-stream twin of :class:`TBlock`: the same parameter names."""

    def __init__(self, cfg: ViTConfig, remat_mlp: bool = False):
        super().__init__()
        self.remat_mlp = remat_mlp
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = Attention(d, cfg.num_heads)
        self.ls1 = LayerScale(d, cfg.layerscale_init)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio))
        self.ls2 = LayerScale(d, cfg.layerscale_init)

    def forward(self, x):
        x = x + self.ls1(self.attn(_layer_norm(self.norm1, x)))
        return x + self.ls2(self._mlp(_layer_norm(self.norm2, x)))

    def _mlp(self, y):
        return _maybe_checkpoint(self.mlp, y) if self.remat_mlp else self.mlp(y)


def _maybe_checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when a
    graph is being recorded."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


class DINOv2ViT(nn.Module):
    """NHWC normalized image ``[B, S, S, 3]`` → final-norm ``patch_tokens
    [B, N, D]`` and ``cls_token [B, D]`` in ``dtype``. ``pos_embed`` is stored
    already resampled to the working grid. The blocks run the channels-major
    stream with ``tp_mode`` "heads", the standard one with "ring"."""

    def __init__(self, cfg: ViTConfig, grid_size: int, dtype=torch.bfloat16,
                 remat_policy: str | None = None, tp_mode: str = "heads"):
        super().__init__()
        if remat_policy not in (None, "block", "mlp"):
            raise ValueError(f"unknown remat_policy {remat_policy!r} "
                             "(expected 'block' or 'mlp')")
        if tp_mode not in ("heads", "ring"):
            raise ValueError(f"unknown tp_mode {tp_mode!r} (expected 'heads' or 'ring')")
        self.transposed = tp_mode != "ring"
        self.cfg = cfg
        self.grid_size = grid_size
        self.dtype = dtype
        self.remat_block = remat_policy == "block"
        d, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Linear(p * p * 3, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid_size * grid_size, d))
        block_cls = TBlock if self.transposed else Block
        self.blocks = nn.ModuleList(block_cls(cfg, remat_mlp=remat_policy == "mlp")
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def init_weights(self, generator):
        """Seeded init of the random weights; LayerNorms and LayerScales keep
        their constructor values (ones/zeros, ``layerscale_init``)."""
        lecun_normal_(self.patch_embed.weight, generator)
        nn.init.zeros_(self.patch_embed.bias)
        with torch.no_grad():
            for t in (self.cls_token, self.pos_embed):
                t.copy_(torch.randn(t.shape, generator=generator) * 0.02)
        for m in self.blocks.modules():
            if isinstance(m, (TLinear, nn.Linear)):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, x):
        B, H, W, _ = x.shape
        p = self.cfg.patch_size
        gh, gw = H // p, W // p
        if not gh == gw == self.grid_size:
            raise ValueError(f"image {H}x{W} is not a {self.grid_size}-patch grid")
        n = gh * gw
        dt = self.dtype

        # patch embedding: unfold to [B, N, p*p*3] in (row, col, channel) order
        patches = x.reshape(B, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(B, n, p * p * 3).to(dt)
        tokens = F.linear(patches, self.patch_embed.weight.to(dt),
                          self.patch_embed.bias.to(dt))
        cls = self.cls_token.to(dt).expand(B, 1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(dt)

        args = ()
        if self.transposed:  # [B, D, padded_len(1+N)] channels-major, zero pad tokens
            n_tok = 1 + n
            tokens = F.pad(tokens.transpose(1, 2), (0, padded_len(n_tok) - n_tok)).contiguous()
            args = (n_tok,)
        for blk in self.blocks:
            tokens = (_maybe_checkpoint(blk, tokens, *args) if self.remat_block
                      else blk(tokens, *args))
        if self.transposed:
            tokens = tokens[:, :, :n_tok].transpose(1, 2)  # drop the pad: [B, 1+N, D]

        tokens = F.layer_norm(tokens.float(), (tokens.shape[-1],),
                              self.norm.weight.float(), self.norm.bias.float(), 1e-6)
        return {
            "patch_tokens": tokens[:, 1:].to(dt),
            "cls_token": tokens[:, 0].to(dt),
        }
