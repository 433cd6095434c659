"""Channels-major LayerNorm: the CUDA kernel K2 and its plain version.

Counterpart of ``multihmr_tpu/ops/norm.py``. The transposed-stream ViT
normalizes over the channel dim of ``[B, D, N]`` twice per block; on a CUDA
tensor :func:`layernorm_cm` launches ``csrc/layernorm_cm.cu`` (one pass over
x, fp32 statistics, affine, cast), on a CPU tensor it runs
:func:`layernorm_cm_reference`. There is no fallback: a CUDA tensor the
kernel does not take raises.

:func:`layernorm_cm` is differentiable. Its backward is the analytic
LayerNorm backward in torch ops on both devices (``_ln_bwd`` of the JAX
package, which wrote no kernel for it): the fp32 statistics are recomputed
from x, so only x and the scale are saved.
"""

from __future__ import annotations

import torch

from multihmr_tpu_torch.ops import cuda_lib

KERNEL = "layernorm_cm"


def _wide(t):
    """fp32 for bf16 and fp32 inputs; fp64 stays fp64 (``gradcheck``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def layernorm_cm_reference(x, scale, bias, eps: float = 1e-6,
                           out_dtype=torch.bfloat16):
    """Plain LayerNorm over dim 1 of ``[B, D, N]``: fp32 mean, fp32 variance
    of the centred values, affine, cast (``_ln_reference`` in the JAX
    package)."""
    xf = _wide(x)
    mu = xf.mean(dim=1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * _wide(scale)[None, :, None] + _wide(bias)[None, :, None]).to(out_dtype)


def _layernorm_cm_cuda(x, scale, bias, eps, out_dtype):
    if x.dim() != 3:
        raise ValueError(f"layernorm_cm expects [B, D, N], got {tuple(x.shape)}")
    B, D, N = x.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or t.shape != (D,):
            raise ValueError(
                f"layernorm_cm: {name} must be fp32 [{D}] on {x.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if x.dtype not in cuda_lib.DTYPE_CODES or out_dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"layernorm_cm: unsupported dtypes {x.dtype} -> {out_dtype}")
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("layernorm_cm: x, scale and bias must be contiguous")
    y = torch.empty((B, D, N), dtype=out_dtype, device=x.device)
    lib = cuda_lib.library()
    err = lib.mhmr_layernorm_cm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        B, D, N, float(eps), cuda_lib.DTYPE_CODES[x.dtype],
        cuda_lib.DTYPE_CODES[out_dtype], cuda_lib.stream_handle(x.device),
    )
    cuda_lib.check(err, KERNEL)
    cuda_lib.LAUNCHES[KERNEL] += 1
    return y


def layernorm_cm_bwd(x, scale, g, eps: float = 1e-6):
    """Analytic backward of :func:`layernorm_cm` for the output gradient
    ``g``: (dx in x's dtype, dscale and dbias in fp32, or fp64 for fp64)."""
    xf, gf = _wide(x), _wide(g)
    mu = xf.mean(dim=1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    yhat = xc * rstd
    dy = gf * _wide(scale)[None, :, None]
    m1 = dy.mean(dim=1, keepdim=True)
    m2 = (dy * yhat).mean(dim=1, keepdim=True)
    dx = (rstd * (dy - m1 - yhat * m2)).to(x.dtype)
    return dx, (gf * yhat).sum(dim=(0, 2)), gf.sum(dim=(0, 2))


def _layernorm_cm_fwd(x, scale, bias, eps, out_dtype):
    if x.device.type == "cpu":
        return layernorm_cm_reference(x, scale, bias, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_cm: no kernel for device {x.device}")
    return _layernorm_cm_cuda(x, scale, bias, eps, out_dtype)


class _LayerNormCM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _layernorm_cm_fwd(x, scale, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layernorm_cm_bwd(x, scale, g, ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None, None


def layernorm_cm(x, scale, bias, eps: float = 1e-6, out_dtype=torch.bfloat16):
    """LayerNorm over the channel dim of ``[B, D, N]`` → ``out_dtype``.

    CPU tensor: the plain version. CUDA tensor: kernel K2, or raise.
    Differentiable in x, scale and bias; with no graph being recorded
    (inference) it skips the autograd Function and its host cost."""
    if not torch.is_grad_enabled():
        return _layernorm_cm_fwd(x, scale, bias, eps, out_dtype)
    return _LayerNormCM.apply(x, scale, bias, eps, out_dtype)
