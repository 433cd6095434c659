"""HPH, the cross-attention SMPL-X regression head (``multihmr_tpu/models/hph.py``).

One query slot per detection-capacity entry ``[B, K]`` with a validity mask.
The head runs in fp32 with plain einsum + softmax attention, exactly as the
JAX package writes it (the masking shifts of -1e11 on keys and -1e6 on
queries are part of the numerics, so no fused attention is used here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multihmr_tpu_torch.config import ModelConfig
from multihmr_tpu_torch.bodymodel.assets import load_mean_params
from multihmr_tpu_torch.models.vit import lecun_normal_
from multihmr_tpu_torch.ops.detection import Detections, scatter_add_grid
from multihmr_tpu_torch.ops.image import grid_to_tokens
from multihmr_tpu_torch.ops.rotations import rot6d_to_rotmat


def init_linear_(m: nn.Linear, generator):
    lecun_normal_(m.weight, generator)
    if m.bias is not None:
        nn.init.zeros_(m.bias)


class MaskedSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x, mask):
        B, K, _ = x.shape
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        heads = lambda t: t.reshape(B, K, self.heads, self.dim_head).transpose(1, 2)
        m = mask[:, None, :, None]
        q, k, v = heads(q) * m, heads(k) * m, heads(v) * m
        dots = torch.einsum("bhnd,bhmd->bhnm", q, k) * (self.dim_head ** -0.5)
        dots = dots - (1.0 - mask)[:, None, None, :] * 1e11  # key mask
        attn = torch.softmax(dots, dim=-1) * mask[:, None, None, :]
        out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
        return self.to_out(out.transpose(1, 2).reshape(B, K, -1))


class MaskedCrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_kv = nn.Linear(context_dim, 2 * inner, bias=False)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x, context, mask):
        B, K, _ = x.shape
        N = context.shape[1]
        k, v = self.to_kv(context).chunk(2, dim=-1)
        q = self.to_q(x).reshape(B, K, self.heads, self.dim_head).transpose(1, 2)
        k = k.reshape(B, N, self.heads, self.dim_head).transpose(1, 2)
        v = v.reshape(B, N, self.heads, self.dim_head).transpose(1, 2)
        q = q * mask[:, None, :, None]
        dots = torch.einsum("bhnd,bhmd->bhnm", q, k) * (self.dim_head ** -0.5)
        # query-axis shift: a softmax no-op kept for parity
        dots = dots - (1.0 - mask)[:, None, :, None] * 1e6
        out = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(dots, dim=-1), v)
        out = out * mask[:, None, :, None]
        return self.to_out(out.transpose(1, 2).reshape(B, K, -1))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class HPH(nn.Module):
    """Queries ``[B, K]`` cross-attend the feature map and decode SMPL-X
    parameters as residuals on the mean-parameter inits."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        hph = cfg.hph
        context_dim = cfg.vit.embed_dim + cfg.camera_embed_dim
        res = cfg.grid_size
        for name in ("cross_queries_x", "cross_queries_y",
                     "cross_values_x", "cross_values_y"):
            setattr(self, name, nn.Parameter(torch.zeros(res, context_dim)))
        mean = load_mean_params(None, nrot=cfg.nrot, num_betas=cfg.num_betas)
        self.init_body_pose = nn.Parameter(torch.from_numpy(mean["pose"]))
        self.init_betas = nn.Parameter(torch.from_numpy(mean["shape"]))
        self.init_cam = nn.Parameter(torch.from_numpy(mean["cam"]))
        self.init_expression = nn.Parameter(torch.from_numpy(mean["expression"]))
        self.to_token_embedding = nn.Linear(cfg.token_dim, hph.dim)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, hph.dim))
        for i in range(hph.depth):
            setattr(self, f"sa_norm{i}", nn.LayerNorm(hph.dim, eps=1e-5))
            setattr(self, f"sa{i}", MaskedSelfAttention(hph.dim, hph.heads, hph.dim_head))
            setattr(self, f"ca_norm{i}", nn.LayerNorm(hph.dim, eps=1e-5))
            setattr(self, f"ca{i}", MaskedCrossAttention(
                hph.dim, context_dim, hph.heads, hph.dim_head))
            setattr(self, f"ff_norm{i}", nn.LayerNorm(hph.dim, eps=1e-5))
            setattr(self, f"ff{i}", FeedForward(hph.dim, hph.mlp_dim))
        self.decpose = nn.Linear(hph.dim, cfg.npose)
        self.decshape = nn.Linear(hph.dim, cfg.num_betas)
        self.deccam = nn.Linear(hph.dim, 3)
        self.decexpression = nn.Linear(hph.dim, 10)

    def init_weights(self, generator):
        with torch.no_grad():
            for name in ("cross_queries_x", "cross_queries_y",
                         "cross_values_x", "cross_values_y"):
                t = getattr(self, name)
                t.copy_(torch.randn(t.shape, generator=generator) * 0.2)
            self.pos_embedding.copy_(torch.randn(self.pos_embedding.shape, generator=generator))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)

    def forward(self, z_central, kv_grid, det: Detections):
        c = self.cfg
        B, K, _ = z_central.shape
        mask = det.valid  # [B, K]

        queries_xy = self.cross_queries_x[det.rows] + self.cross_queries_y[det.cols]
        x_central = z_central + queries_xy * mask[..., None]
        values_xy = self.cross_values_x[det.rows] + self.cross_values_y[det.cols]
        context = grid_to_tokens(scatter_add_grid(kv_grid, det, values_xy))

        expand = lambda t: t[0].expand(B, K, t.shape[-1])
        token = torch.cat([x_central, expand(self.init_body_pose),
                           expand(self.init_betas), expand(self.init_cam)], dim=-1)
        x = self.to_token_embedding(token) + self.pos_embedding[:, 0][:, None, :]

        m = mask[..., None]
        for i in range(c.hph.depth):
            y = getattr(self, f"sa_norm{i}")(x * m)
            x = getattr(self, f"sa{i}")(y, mask) + x * m
            y = getattr(self, f"ca_norm{i}")(x)
            x = getattr(self, f"ca{i}")(y, context, mask) + x
            y = getattr(self, f"ff_norm{i}")(x)
            x = getattr(self, f"ff{i}")(y) + x
        x = x * m

        pose6d = self.decpose(x) + self.init_body_pose[None]
        betas = self.decshape(x) + self.init_betas[None]
        cam = self.deccam(x) + self.init_cam[None]
        expression = self.decexpression(x) + self.init_expression[None]
        rotmat = rot6d_to_rotmat(pose6d.reshape(B, K, c.nrot, 6))
        return {"rotmat": rotmat, "betas": betas, "cam": cam, "expression": expression}
