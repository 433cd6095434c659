"""Attention: the CUDA flash kernels K1, K3, K4a, K4b, K5 and their plain
versions.

Counterpart of ``multihmr_tpu/ops/attention.py``, in two layouts:

  * channels-major (``_flash_fwd_impl_t``, ``_flash_bwd_impl_t``,
    ``mha_reference_t``, ``flash_attention_t``): q, k and v are
    ``[B, H, Dh, N]``, the layout the channels-major ViT's qkv projection
    produces for free. The forward launches ``csrc/flash_fwd.cu`` (K1), the
    backward ``csrc/flash_bwd.cu`` (K3 fused, or K4a + K4b two-pass);
  * standard (``mha_reference``, ``flash_fwd_reference``, ``_flash_fwd_std``,
    ``flash_attention_qkv``, ``attention_qkv``): q, k and v are
    ``[B, H, N, Dh]``, views of the packed ``[B, N, 3, H, Dh]`` projection of
    the standard ``[B, N, D]`` stream. The forward launches
    ``csrc/flash_fwd_std.cu`` (K5); the backward copies into K3's layout, as
    the JAX package's ``_flash_bwd_impl`` does, padded to a multiple of 8
    tokens. ``attention_qkv`` is the one
    entry the standard-stream ViT calls; the JAX package's per-tensor entries
    (``flash_attention``, ``flash_attention_trainable``,
    ``flash_attention_merged``, ``multi_head_attention``,
    ``attention_merged``) have no caller in the port and are not ported.

On a CUDA tensor each entry launches its kernel; on a CPU tensor it runs the
plain version. There is no fallback: a CUDA tensor a kernel does not take
raises. The bf16 K1 and K3 take only 16-byte token rows (a token count and
strides that are multiples of 8: :func:`padded_len`, :func:`_check_rows16`);
their fp32 paths, K4a and K4b take any strides. The JAX standard entries'
TPU tiling arguments (``block_q``, ``block_kv``, ``pad_to``, ``interpret``)
and the ``N >= 1024`` flash threshold of its dispatchers are TPU tuning and
are not ported: on CUDA ``attention_qkv`` takes K5 at every N.
"""

from __future__ import annotations

import torch

from multihmr_tpu_torch.ops import cuda_lib

KERNEL = "flash_fwd_t"            # K1
KERNEL_BWD = "flash_bwd_fused_t"  # K3
KERNEL_BWD_DQ = "flash_bwd_dq_t"  # K4a
KERNEL_BWD_DKV = "flash_bwd_dkv_t"  # K4b
KERNEL_STD = "flash_fwd_std"      # K5
HEAD_DIM = 64  # the kernels specialise on Dh = 64 (all six SMPL-X configs)
_BWD_MODES = {KERNEL_BWD: 0, KERNEL_BWD_DQ: 1, KERNEL_BWD_DKV: 2}


def _key_mask(N, kv_len, device):
    """[N] bool, True for keys < kv_len; None when nothing is masked."""
    if kv_len is None or kv_len == N:
        return None
    return torch.arange(N, device=device) < kv_len


def _wide(t):
    """fp32 for bf16 and fp32 inputs; fp64 stays fp64 (``gradcheck``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def mha_reference_t(q, k, v, scale=None, kv_len=None):
    """Plain attention in the channels-major layout, computed in fp32 (fp64
    for fp64 inputs).

    Returns (out ``[B, H, Dh, N]`` in q's dtype, natural-log lse
    ``[B, H, N]`` fp32). Keys at or past ``kv_len`` are masked."""
    if scale is None:
        scale = q.shape[-2] ** -0.5
    logits = torch.einsum("bhdn,bhdm->bhnm", _wide(q), _wide(k)) * scale
    keep = _key_mask(q.shape[-1], kv_len, q.device)
    if keep is not None:
        logits = logits.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhnm,bhdm->bhdn", probs, _wide(v))
    return out.to(q.dtype), lse


def flash_bwd_reference_t(q, k, v, o, lse, do, scale=None, kv_len=None):
    """Plain flash-attention backward in fp32 (fp64 for fp64 inputs),
    ``[B, H, Dh, N]`` in and out.

    Materialises p = exp(s - lse) and D = rowsum(dO * o), then
    ds = p * (dp - D). Keys at or past ``kv_len`` are masked, so dk and dv
    are exact zeros there. Returns (dq, dk, dv) in q's dtype."""
    if scale is None:
        scale = q.shape[-2] ** -0.5
    qf, kf, vf, dof = _wide(q), _wide(k), _wide(v), _wide(do)
    s = torch.einsum("bhdn,bhdm->bhnm", qf, kf) * scale
    keep = _key_mask(q.shape[-1], kv_len, q.device)
    if keep is not None:  # before the exp: junk keys may overflow it
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - _wide(lse)[..., None])
    dd = (dof * _wide(o)).sum(2)  # [B, H, N]
    dp = torch.einsum("bhdn,bhdm->bhnm", dof, vf)
    ds = p * (dp - dd[..., None])
    dq = torch.einsum("bhnm,bhdm->bhdn", ds, kf) * scale
    dk = torch.einsum("bhnm,bhdn->bhdm", ds, qf) * scale
    dv = torch.einsum("bhnm,bhdn->bhdm", p, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_qkv(q, k, v, kv_len, what):
    if q.dim() != 4:
        raise ValueError(f"{what} expects [B, H, Dh, N], got {tuple(q.shape)}")
    Dh, N = q.shape[-2:]
    if Dh != HEAD_DIM:
        raise ValueError(f"{what}: kernel takes Dh={HEAD_DIM}, got {Dh}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: {name} differs from q in shape, dtype or device")
        if t.stride() != q.stride():
            raise ValueError(f"{what}: q, k and v must share their strides")
    if q.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {q.dtype}")
    if not 1 <= kv_len <= N:
        raise ValueError(f"{what}: kv_len={kv_len} outside [1, {N}]")


def padded_len(n_tok: int) -> int:
    """The token count the bf16 K1 and K3 take for ``n_tok`` true tokens:
    rounded up to a multiple of 8 (16 bytes of bf16 per channel row)."""
    return -(-n_tok // 8) * 8


def _check_rows16(what, **tensors):
    """The bf16 K1 and K3 copy their tiles as 16-byte rows of 8 tokens
    (``cp.async``): each ``[B, H, Dh, N]`` operand needs token stride 1, a
    token count and channel, head and batch strides that are multiples of 8,
    and a 16-byte aligned base pointer; ``[B, H, N]`` fp32 rows (lse, D) a
    16-byte aligned base. Nothing pads or copies here: the channels-major ViT
    pre-pads its stream (models/vit.py), the standard stream's backward
    copies into a padded buffer."""
    for name, t in tensors.items():
        bad = t.data_ptr() % 16 != 0
        if t.dim() == 4:
            bad |= (t.stride(-1) != 1 or t.shape[-1] % 8 != 0
                    or any(s % 8 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))
        if bad:
            raise ValueError(
                f"{what}: bf16 K1/K3 copy 16-byte token rows, so {name} needs token stride 1, "
                f"a token count and channel/head/batch strides that are multiples of 8 and a "
                f"16-byte aligned base (pre-pad the stream to a multiple of 8 tokens); got shape "
                f"{tuple(t.shape)}, strides {t.stride()}, base {t.data_ptr() % 16} mod 16")


def _flash_fwd_t_cuda(q, k, v, scale, kv_len):
    _check_qkv(q, k, v, kv_len, "_flash_fwd_impl_t")
    if q.dtype == torch.bfloat16:
        _check_rows16("_flash_fwd_impl_t", q=q, k=k, v=v)
    B, H, Dh, N = q.shape
    out = torch.empty((B, H, Dh, N), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    lib = cuda_lib.library()
    err = lib.mhmr_flash_fwd_t(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, H, Dh, N, kv_len, *q.stride(), float(scale),
        cuda_lib.DTYPE_CODES[q.dtype], cuda_lib.stream_handle(q.device),
    )
    cuda_lib.check(err, KERNEL)
    cuda_lib.LAUNCHES[KERNEL] += 1
    return out, lse


def _dispatch(q, what):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {q.device}")
    return q.device.type == "cuda"


def _flash_fwd_impl_t(q, k, v, scale=None, kv_len=None):
    """``[B, H, Dh, N]`` in → (out ``[B, H, Dh, N]``, lse ``[B, H, N]``).

    CPU tensor: the plain version. CUDA tensor: kernel K1, or raise."""
    if not _dispatch(q, "_flash_fwd_impl_t"):
        return mha_reference_t(q, k, v, scale, kv_len)
    N = q.shape[-1]
    if scale is None:
        scale = q.shape[-2] ** -0.5
    return _flash_fwd_t_cuda(q, k, v, scale, N if kv_len is None else kv_len)


def _out_strides(t, shape, what):
    """(batch, head) strides of an output view that is contiguous within
    each head, as the backward kernels write it."""
    if t.shape != shape or t.stride()[2:] != (shape[-1], 1):
        raise ValueError(f"{what}: outputs must be [B, H, Dh, N] views, contiguous "
                         f"within each head; got {tuple(t.shape)} {t.stride()}")
    return t.stride()[:2]


def _flash_bwd_t_cuda(kernel, q, k, v, do, lse, dd, scale, kv_len, dq, dk, dv):
    """Launch one entry of csrc/flash_bwd.cu (mode 0 = K3, 1 = K4a, 2 = K4b)."""
    _check_qkv(q, k, v, kv_len, kernel)
    B, H, Dh, N = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{kernel}: dO differs from q in shape, dtype or device")
    for t in (lse, dd):
        if t.shape != (B, H, N) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{kernel}: lse and D must be contiguous fp32 [B, H, N]")
    mode = _BWD_MODES[kernel]
    outs = [t for t, used in ((dq, mode != 2), (dk, mode != 1), (dv, mode != 1)) if used]
    strides = {_out_strides(t, q.shape, kernel) for t in outs}
    if len(strides) != 1 or any(t.dtype != q.dtype for t in outs):
        raise ValueError(f"{kernel}: dq, dk and dv must share dtype and strides")
    (ob, oh), = strides
    dq_acc = None
    if mode == 0 and q.dtype == torch.bfloat16:  # K3 adds scaled fp32 partials here
        _check_rows16(kernel, q=q, k=k, v=v, dO=do, dq=dq, dk=dk, dv=dv, lse=lse, D=dd)
        # by 64-query tile, rows padded to 68: one bulk add per partial
        dq_acc = torch.zeros((B, H, -(-N // 64), Dh, 68), dtype=torch.float32,
                             device=q.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    err = cuda_lib.library().mhmr_flash_bwd_t(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dd.data_ptr(), ptr(dq), ptr(dq_acc), ptr(dk), ptr(dv),
        B, H, Dh, N, kv_len, *q.stride(), *do.stride(), ob, oh, float(scale),
        cuda_lib.DTYPE_CODES[q.dtype], mode, cuda_lib.stream_handle(q.device),
    )
    cuda_lib.check(err, kernel)
    cuda_lib.LAUNCHES[kernel] += 1
    if dq_acc is not None:
        dq.copy_(dq_acc[..., :64].permute(0, 1, 3, 2, 4).reshape(B, H, Dh, -1)[..., :N])


def _flash_bwd_impl_t(q, k, v, o, lse, do, scale=None, kv_len=None, fused=True,
                      out=None):
    """Flash-attention backward, ``[B, H, Dh, N]`` in → (dq, dk, dv).

    CPU tensor: :func:`flash_bwd_reference_t`. CUDA tensor: kernel K3
    (``fused``) or K4a then K4b, or raise. D = rowsum(dO * o) is computed
    here in fp32, outside the kernels. ``out``: optional (dq, dk, dv) to
    write into, each contiguous within a head (slices of one packed
    gradient work). Keys at or past ``kv_len`` get exact-zero dk and dv."""
    if not _dispatch(q, "_flash_bwd_impl_t"):
        grads = flash_bwd_reference_t(q, k, v, o, lse, do, scale, kv_len)
        if out is None:
            return grads
        for t, g in zip(out, grads):
            t.copy_(g)
        return tuple(out)
    B, H, Dh, N = q.shape
    if scale is None:
        scale = Dh ** -0.5
    kv_len = N if kv_len is None else kv_len
    if out is None:
        out = tuple(torch.empty((B, H, Dh, N), dtype=q.dtype, device=q.device)
                    for _ in range(3))
    dd = (do.float() * o.float()).sum(2)
    lse = lse.float().contiguous()
    args = (q, k, v, do, lse, dd, scale, kv_len, *out)
    if fused:
        _flash_bwd_t_cuda(KERNEL_BWD, *args)
    else:
        _flash_bwd_t_cuda(KERNEL_BWD_DQ, *args)
        _flash_bwd_t_cuda(KERNEL_BWD_DKV, *args)
    return tuple(out)


class _FlashAttentionT(torch.autograd.Function):
    """Packed qkv ``[B, 3, H, Dh, N]`` → out ``[B, H, Dh, N]``; the backward
    (K3, as the JAX ``_fat_bwd``) writes dq, dk and dv into one packed
    gradient, so autograd pays no zero-fill-and-copy per ``qkv[:, i]``
    slice."""

    @staticmethod
    def forward(ctx, qkv, scale, kv_len):
        q, k, v = qkv.unbind(1)
        out, lse = _flash_fwd_impl_t(q, k, v, scale, kv_len)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (scale, kv_len)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        scale, kv_len = ctx.args
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        _flash_bwd_impl_t(*qkv.unbind(1), out, lse, g, scale, kv_len, out=dqkv.unbind(1))
        return dqkv, None, None


def flash_attention_qkv_t(qkv, scale=None, kv_len=None):
    """Differentiable attention on packed ``qkv [B, 3, H, Dh, N]`` →
    ``[B, H, Dh, N]``: K1 forward and K3 backward on CUDA; the plain
    versions on the CPU. With no graph being recorded (inference) it calls
    the forward directly, without the autograd Function's host cost."""
    if not torch.is_grad_enabled():
        return _flash_fwd_impl_t(*qkv.unbind(1), scale, kv_len)[0]
    return _FlashAttentionT.apply(qkv, scale, kv_len)


def flash_attention_t(q, k, v, scale=None, kv_len=None):
    """Differentiable channels-major flash attention, ``[B, H, Dh, N]`` in
    and out (``flash_attention_t`` of the JAX package). Packs q, k and v
    (one copy) and calls :func:`flash_attention_qkv_t`."""
    return flash_attention_qkv_t(torch.stack((q, k, v), 1), scale, kv_len)


# ---------------------------------------------------------------------------
# Standard layout: q, k and v are [B, H, N, Dh]


def mha_reference(q, k, v, scale=None):
    """Plain attention, ``[B, H, N, Dh]`` in and out (the JAX package's
    ``mha_reference``): scores in q's dtype, the softmax in fp32, the
    probabilities cast to v's dtype before P.V."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", probs, v)


def flash_fwd_reference(q, k, v, scale=None):
    """K5's plain version: ``[B, H, N, Dh]`` in → (out ``[B, H, N, Dh]`` in
    q's dtype, natural-log lse ``[B, H, N]``), computed in fp32 (fp64 for
    fp64 inputs)."""
    out_t, lse = mha_reference_t(*(t.transpose(-1, -2) for t in (q, k, v)), scale)
    return out_t.transpose(-1, -2), lse


def _check_std(q, k, v, out, what):
    if q.dim() != 4:
        raise ValueError(f"{what} expects [B, H, N, Dh], got {tuple(q.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{what}: kernel takes Dh={HEAD_DIM}, got {q.shape[-1]}")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: {name} differs from q in shape, dtype or device")
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError(f"{what}: q, k and v must share their strides")
    if q.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {q.dtype}")
    vec = 16 // q.element_size()  # elements per 16-byte load
    if (q.stride(-1) != 1 or any(s % vec for s in q.stride()[:3])
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"{what}: K5 loads 16-byte token rows: the channel stride must be 1 "
                         f"and the other strides and base pointers 16-byte aligned; got "
                         f"strides {q.stride()}")


def _flash_fwd_std(q, k, v, scale=None, out=None):
    """``[B, H, N, Dh]`` in → (out ``[B, H, N, Dh]``, lse ``[B, H, N]`` fp32).

    CPU tensor: :func:`flash_fwd_reference`. CUDA tensor: kernel K5, or
    raise. ``out``: an optional ``[B, H, N, Dh]`` view to write, with any
    strides; by default a view of a fresh ``[B, N, H, Dh]`` buffer, so that
    merging the heads into ``[B, N, H * Dh]`` is a free reshape."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not _dispatch(q, "_flash_fwd_std"):
        o, lse = flash_fwd_reference(q, k, v, scale)
        return (o, lse) if out is None else (out.copy_(o), lse)
    B, H, N, Dh = q.shape
    if out is None:
        out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    _check_std(q, k, v, out, "_flash_fwd_std")
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    err = cuda_lib.library().mhmr_flash_fwd_std(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, H, Dh, N, *q.stride(), *out.stride(), float(scale),
        cuda_lib.DTYPE_CODES[q.dtype], cuda_lib.stream_handle(q.device),
    )
    cuda_lib.check(err, KERNEL_STD)
    cuda_lib.LAUNCHES[KERNEL_STD] += 1
    return out, lse


def _merge_heads(out):
    """``[B, H, N, Dh]`` → ``[B, N, H * Dh]`` (free for K5's default output)."""
    B, H, N, Dh = out.shape
    return out.transpose(1, 2).reshape(B, N, H * Dh)


def _unpack(qkv):
    """Packed ``[B, N, 3, H, Dh]`` → q, k, v ``[B, H, N, Dh]`` views."""
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


def _padded_copy(t, n_pad):
    """A contiguous copy of ``t`` with its last dim zero-padded to ``n_pad``."""
    n = t.shape[-1]
    out = t.new_empty(t.shape[:-1] + (n_pad,))
    out[..., :n].copy_(t)
    out[..., n:].zero_()
    return out


class _FlashAttentionQKV(torch.autograd.Function):
    """Packed qkv ``[B, N, 3, H, Dh]`` (the standard stream's projection) →
    heads-merged out ``[B, N, H * Dh]``. The backward (as the JAX
    ``_fam_bwd``) copies q, k, v, o and dO into contiguous channels-major
    tensors for K3 and returns one packed ``[B, N, 3, H, Dh]`` gradient, so
    autograd pays no zero-fill-and-copy per q/k/v slice."""

    @staticmethod
    def forward(ctx, qkv, scale):
        out, lse = _flash_fwd_std(*_unpack(qkv), scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale = scale
        return _merge_heads(out)

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        B, N, _, H, Dh = qkv.shape
        # K3's layout, N rounded up to a multiple of 8 tokens (its 16-byte
        # rows) with kv_len = N. The pad queries have zero q and dO (so
        # D = 0) and lse 0, which keeps p = exp(0 - 0) finite: they add
        # nothing to dk or dv. The pad keys' dk, dv and the pad queries' dq
        # are sliced off.
        n_pad = padded_len(N)
        qkv_t = _padded_copy(qkv.permute(0, 2, 3, 4, 1), n_pad)  # [B, 3, H, Dh, n_pad]
        o_t = _padded_copy(out.transpose(-1, -2), n_pad)
        do_t = _padded_copy(g.reshape(B, N, H, Dh).permute(0, 2, 3, 1), n_pad)
        dqkv_t = torch.empty_like(qkv_t)
        _flash_bwd_impl_t(*qkv_t.unbind(1), o_t, _padded_copy(lse, n_pad), do_t, ctx.scale,
                          kv_len=N, out=dqkv_t.unbind(1))
        return dqkv_t[..., :N].permute(0, 4, 1, 2, 3).contiguous(), None


def flash_attention_qkv(qkv, scale=None):
    """Differentiable attention on packed ``qkv [B, N, 3, H, Dh]`` →
    ``[B, N, H * Dh]``: K5 forward and K3 backward on CUDA, the plain
    versions on the CPU. With no graph being recorded it calls the forward
    directly, without the autograd Function's host cost."""
    if not torch.is_grad_enabled():
        return _merge_heads(_flash_fwd_std(*_unpack(qkv), scale)[0])
    return _FlashAttentionQKV.apply(qkv, scale)


def attention_qkv(qkv, scale=None):
    """The standard-stream ViT's attention: packed ``[B, N, 3, H, Dh]`` →
    ``[B, N, H * Dh]``. CUDA: :func:`flash_attention_qkv`; CPU:
    :func:`mha_reference`, the JAX package's path off the TPU."""
    if _dispatch(qkv, "attention_qkv"):
        return flash_attention_qkv(qkv, scale)
    return _merge_heads(mha_reference(*_unpack(qkv), scale))
