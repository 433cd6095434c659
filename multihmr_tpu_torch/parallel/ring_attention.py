"""Attention over the ``model`` axis of the mesh
(``multihmr_tpu/parallel/ring_attention.py``): ring attention over sequence
shards, and head-parallel attention.

In the JAX package these take global arrays and run under ``shard_map``.
Here each rank runs its own program, so:

  * :func:`ring_attention` takes this rank's sequence shards of q, k and v
    (``[B, H, N/P, Dh]``, rank ``r`` holding tokens ``r·N/P ...``) and
    returns its shard of the output: the kv shards go once round the ring
    (:func:`~multihmr_tpu_torch.parallel.comm.ring_shift`, ``P - 1``
    shifts) while each rank combines its queries' online softmax. The
    standard-stream ViT keeps its sequence shard through all the blocks and
    calls this directly (models/vit.py);
  * the other entries take and return whole tensors, replicated on the
    ranks of the axis, as the JAX functions' global values:
    :func:`sequence_parallel_attention` pads the sequence to a multiple of
    ``P``, splits it, rings and gathers; :func:`head_parallel_attention`
    attends over the rank's heads and gathers them; ``mesh_attention*``
    dispatch between them and the single-device path.

A ``data`` axis needs no ``batch_axis`` here: each data rank holds its own
batch slice already. The per-shard attention is the plain einsum of the JAX
``_local_attn_stats`` (the JAX package does not run it through Pallas
either).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multihmr_tpu_torch.ops.attention import (
    attention_merged,
    flash_attention_t,
    multi_head_attention,
)
from multihmr_tpu_torch.parallel import comm
from multihmr_tpu_torch.parallel.sharding import axis_size


def _local_attn_stats(q, k, v, scale, col_base=None, kv_len=None):
    """Attention of the queries over one kv shard: (unnormalised out fp32,
    row max, row sum of exp). Keys at global column ``col_base + j >= kv_len``
    are masked (logit -1e30), so a fully masked shard contributes 0 in the
    combine. The row max is a stabiliser the result does not depend on, so
    it carries no gradient."""
    s = torch.einsum("bhnd,bhmd->bhnm", q, k).float() * scale
    if kv_len is not None:
        col = col_base + torch.arange(k.shape[2], device=k.device)
        s = torch.where(col < kv_len, s, torch.full_like(s, -1e30))
    m = s.amax(-1).detach()
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhnm,bhmd->bhnd", p.to(v.dtype), v).float()
    return o, m, p.sum(-1)


def ring_attention(q, k, v, group, scale=None, kv_len=None):
    """Exact attention over sequence shards: this rank's q, k, v
    ``[B, H, N/P, Dh]`` → its ``[B, H, N/P, Dh]`` out, in q's dtype. Keys at
    global positions ``>= kv_len`` are masked (a sequence padded to a
    multiple of ``P``). Differentiable: the backward shifts the gradients
    the other way round."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, me, shard = comm.group_size(group), comm.group_rank(group), q.shape[2]
    o, m, l = _local_attn_stats(q, k, v, scale, me * shard, kv_len)
    for step in range(1, n):
        k, v = comm.ring_shift(k, group), comm.ring_shift(v, group)
        o2, m2, l2 = _local_attn_stats(q, k, v, scale, ((me - step) % n) * shard, kv_len)
        m_new = torch.maximum(m, m2)
        c1, c2 = torch.exp(m - m_new), torch.exp(m2 - m_new)
        o = o * c1[..., None] + o2 * c2[..., None]
        l = l * c1 + l2 * c2
        m = m_new
    return (o / l[..., None]).to(q.dtype)


def sequence_parallel_attention(q, k, v, group, scale=None):
    """Ring attention for any N on whole ``[B, H, N, Dh]`` tensors, equal on
    every rank of ``group``: pads N up to a multiple of the group's size
    (pad keys masked, pad queries dropped), splits, rings and gathers."""
    n = comm.group_size(group)
    N = q.shape[2]
    Np = -(-N // n) * n
    pad = lambda t: F.pad(t, (0, 0, 0, Np - N)) if Np != N else t  # noqa: E731
    q, k, v = (comm.split(pad(t), 2, group) for t in (q, k, v))
    out = ring_attention(q, k, v, group, scale, kv_len=N if Np != N else None)
    return comm.gather(out, 2, group)[:, :, :N]


def head_parallel_attention(q, k, v, group, scale=None):
    """Attention over this rank's share of the heads of whole ``[B, H, N,
    Dh]`` tensors, the heads gathered back: no communication but the gather
    (within the ViT the column-parallel qkv gives each rank its heads
    directly, and nothing is gathered)."""
    q, k, v = (comm.split(t, 1, group) for t in (q, k, v))
    return comm.gather(multi_head_attention(q, k, v, scale), 1, group)


def _model_group(mesh, H, mode):
    """The ``model`` axis' process group, or None for the single-device path
    (no mesh, or a model axis of 1); checks the head count for "heads"."""
    n = axis_size(mesh, "model")
    if n == 1:
        return None
    if mode not in ("heads", "ring"):
        raise ValueError(f"unknown mode {mode!r} (expected 'heads' or 'ring')")
    if mode == "heads" and H % n:
        raise ValueError(f"num_heads={H} not divisible by mesh axis 'model'={n}")
    return mesh["model"].get_group()


def mesh_attention(q, k, v, mesh, mode: str = "heads", scale=None):
    """``[B, H, N, Dh]`` in and out: no mesh or a model axis of 1 → the
    single-device attention; ``mode="heads"`` → heads over the mesh's
    ``model`` axis; ``"ring"`` → the sequence over it."""
    group = _model_group(mesh, q.shape[1], mode)
    if group is None:
        return multi_head_attention(q, k, v, scale)
    if mode == "ring":
        return sequence_parallel_attention(q, k, v, group, scale)
    return head_parallel_attention(q, k, v, group, scale)


def mesh_attention_merged(q, k, v, mesh, mode: str = "heads", scale=None):
    """:func:`mesh_attention` returning the heads merged, ``[B, N, H·Dh]``."""
    B, H, N, Dh = q.shape
    if _model_group(mesh, H, mode) is None:
        return attention_merged(q, k, v, scale)
    return mesh_attention(q, k, v, mesh, mode, scale).transpose(1, 2).reshape(B, N, H * Dh)


def mesh_attention_t(q, k, v, mesh, mode: str = "heads", scale=None, kv_len=None):
    """Channels-major ``[B, H, Dh, N]`` in and out. "heads" runs the flash
    attention (K1 forward, K3 backward on CUDA) over the rank's heads; "ring"
    transposes to the standard layout at the boundary."""
    group = _model_group(mesh, q.shape[1], mode)
    if group is None:
        return flash_attention_t(q, k, v, scale, kv_len)
    if mode == "ring":
        if kv_len is not None:
            raise ValueError("the pre-padded stream is not used with ring attention")
        std = lambda t: t.transpose(-1, -2)  # noqa: E731
        return std(sequence_parallel_attention(std(q), std(k), std(v), group, scale))
    q, k, v = (comm.split(t, 1, group) for t in (q, k, v))
    return comm.gather(flash_attention_t(q, k, v, scale, kv_len), 1, group)
