"""Channels-major attention: the CUDA flash kernels K1, K3, K4a, K4b and their
plain versions.

Counterpart of the transposed-stream entries of ``multihmr_tpu/ops/attention.py``
(``_flash_fwd_impl_t``, ``_flash_bwd_impl_t``, ``mha_reference_t``,
``flash_attention_t``). q, k and v are ``[B, H, Dh, N]``, the layout the ViT's
qkv projection produces for free. On a CUDA tensor the forward launches
``csrc/flash_fwd.cu`` (K1) and the backward ``csrc/flash_bwd.cu`` (K3 fused,
or K4a + K4b two-pass); on a CPU tensor each runs its plain version. There
is no fallback: a CUDA tensor a kernel does not take raises.
"""

from __future__ import annotations

import torch

from multihmr_tpu_torch.ops import cuda_lib

KERNEL = "flash_fwd_t"            # K1
KERNEL_BWD = "flash_bwd_fused_t"  # K3
KERNEL_BWD_DQ = "flash_bwd_dq_t"  # K4a
KERNEL_BWD_DKV = "flash_bwd_dkv_t"  # K4b
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


def _flash_fwd_t_cuda(q, k, v, scale, kv_len):
    _check_qkv(q, k, v, kv_len, "_flash_fwd_impl_t")
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
        dq_acc = torch.zeros((B, H, Dh, N), dtype=torch.float32, device=q.device)
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
        dq.copy_(dq_acc)


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
