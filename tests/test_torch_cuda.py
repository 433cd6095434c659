"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card and skip without one. The machine with the card
has no jax, and tests/conftest.py imports it, so run them there with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 kernels against the fp32 plain version, 1e-5 on out (fp32
sums in another order) and 1e-5 on lse. bf16 kernels against the plain
version computed in fp32 from the same bf16 inputs: out 2e-2 (P is rounded to
bf16 before P.V and out is rounded to bf16; |out| < 4), lse 1e-3 (fp32
statistics from fp32 scores). LayerNorm: fp32 out 1e-5; bf16 out one bf16
ulp of |y| <= 8 (2^-7 relative).

Flash backward (K3, K4a + K4b) against the plain fp32 backward on the same
inputs, each gradient's max error relative to its largest magnitude: fp32
1e-4 (fp32 sums in other orders, dq's by atomics in a varying order); bf16
1e-2 (the kernels round p and ds to bf16 before their products, as the TPU
kernels do, and the outputs to bf16: 2^-9 relative each).
"""

import numpy as np
import pytest
import torch

from multihmr_tpu_torch.ops import attention, cuda_lib, norm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,kv_len", [(97, None), (2305, None), (640, 577)])
def test_flash_attention_kernel(dev, dtype, n, kv_len):
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((2, 3 * 4 * 64, n), device=dev, generator=g).to(dtype)
    if kv_len is not None:
        qkv[..., kv_len:] = 100.0  # junk past kv_len
    q, k, v = qkv.reshape(2, 3, 4, 64, n).unbind(1)  # strided views, as in the ViT
    cuda_lib.reset_launches()
    out, lse = attention._flash_fwd_impl_t(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[attention.KERNEL] == 1
    ref_out, ref_lse = attention.mha_reference_t(q, k, v, kv_len=kv_len)
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (2, 4, n)
    lim = n if kv_len is None else kv_len
    tol_out, tol_lse = (1e-5, 1e-5) if dtype == torch.float32 else (2e-2, 1e-3)
    assert _max_err(out[..., :lim], ref_out[..., :lim]) <= tol_out
    assert _max_err(lse[..., :lim], ref_lse[..., :lim]) <= tol_lse


def test_flash_attention_rejects(dev):
    q = torch.zeros((1, 2, 32, 16), device=dev)
    with pytest.raises(ValueError, match="Dh=64"):
        attention._flash_fwd_impl_t(q, q, q)
    q = torch.zeros((1, 2, 64, 16), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        attention._flash_fwd_impl_t(q, q, q)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_layernorm_kernel(dev, in_dtype, out_dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn((2, 384, 333), device=dev, generator=g) * 3 + 1).to(in_dtype)
    scale = torch.randn(384, device=dev, generator=g)
    bias = torch.randn(384, device=dev, generator=g)
    cuda_lib.reset_launches()
    y = norm.layernorm_cm(x, scale, bias, 1e-6, out_dtype)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[norm.KERNEL] == 1 and y.dtype == out_dtype
    ref = norm.layernorm_cm_reference(x, scale, bias, 1e-6, torch.float32)
    err = (y.float() - ref).abs()
    if out_dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert (err <= ref.abs() * 2 ** -7 + 1e-6).all()


def test_layernorm_rejects(dev):
    x = torch.zeros((1, 8, 4), device=dev).transpose(1, 2)
    s = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        norm.layernorm_cm(x, s, s)


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _bwd_inputs(dev, dtype, n, kv_len, heads=4, seed=0):
    """q, k, v as strided views of one projection output (junk past
    kv_len), o and lse from the plain forward, a random dO."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((2, 3 * heads * 64, n), device=dev, generator=g).to(dtype)
    if kv_len is not None:
        qkv[..., kv_len:] = 30.0
    q, k, v = qkv.reshape(2, 3, heads, 64, n).unbind(1)
    o, lse = attention.mha_reference_t(q, k, v, kv_len=kv_len)
    do = torch.randn(q.shape, device=dev, generator=g).to(dtype)
    return q, k, v, o, lse, do


def _rel(a, b):
    return _max_err(a, b) / max(b.float().abs().max().item(), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,kv_len", [(97, None), (640, 577), (2305, None)])
def test_flash_backward_kernels(dev, dtype, n, kv_len):
    q, k, v, o, lse, do = _bwd_inputs(dev, dtype, n, kv_len)
    ref = attention.flash_bwd_reference_t(q, k, v, o, lse, do, kv_len=kv_len)
    cuda_lib.reset_launches()
    fused = attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=True)
    two = attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=False)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[attention.KERNEL_BWD] == 1
    assert cuda_lib.LAUNCHES[attention.KERNEL_BWD_DQ] == 1
    assert cuda_lib.LAUNCHES[attention.KERNEL_BWD_DKV] == 1
    for name, a, b, r in zip("qkv", fused, two, ref):
        assert a.dtype == dtype and a.shape == q.shape, name
        assert _rel(a, r) <= BWD_TOL[dtype], (name, _rel(a, r))
        assert _rel(b, r) <= BWD_TOL[dtype], (name, _rel(b, r))
    if kv_len is not None:  # keys past kv_len: exact zeros
        for t in fused[1:] + two[1:]:
            assert not t[..., kv_len:].any()


def test_flash_backward_into_packed_gradient(dev):
    q, k, v, o, lse, do = _bwd_inputs(dev, torch.bfloat16, 300, None)
    packed = torch.empty((2, 3) + q.shape[1:], dtype=q.dtype, device=dev)
    out = attention._flash_bwd_impl_t(q, k, v, o, lse, do, out=packed.unbind(1))
    want = attention._flash_bwd_impl_t(q, k, v, o, lse, do)
    for a, b, c in zip(out, packed.unbind(1), want):
        assert a.data_ptr() == b.data_ptr()
        # dk, dv equal; dq may differ by a bf16 ulp (atomics in another order)
        assert _rel(b, c) <= BWD_TOL[torch.bfloat16]


def test_tiny_slice_gpu_matches_cpu(dev):
    from multihmr_tpu_torch.config import ModelConfig, ViTConfig
    from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
    from multihmr_tpu_torch.bodymodel.core import BodyModel
    from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet

    cfg = ModelConfig(img_size=56, max_people=4, compute_dtype="float32",
                      vit_override=ViTConfig(embed_dim=128, depth=2, num_heads=2))
    arrays = synthetic_body_model(num_joints=55, num_vertices=300, num_extra=21, num_lmk=51)
    net = MultiHMRNet(cfg).init_weights(torch.Generator().manual_seed(0))
    cpu = MultiHMR(cfg, BodyModel.from_arrays(arrays, "cpu"), net=net)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 56, 56, 3)).astype(np.float32))
    K = torch.tensor([[[100.0, 0, 28], [0, 100, 28], [0, 0, 1]]])
    with torch.inference_mode():
        a = cpu.forward(x, K, det_thresh=0.0)
        gpu = MultiHMR(cfg, BodyModel.from_arrays(arrays, dev), net=net.to(dev))
        cuda_lib.reset_launches()
        b = gpu.forward(x.to(dev), K.to(dev), det_thresh=0.0)
    assert cuda_lib.LAUNCHES[attention.KERNEL] == 2 and cuda_lib.LAUNCHES[norm.KERNEL] == 4
    assert torch.equal(a["det"].rows, b["det"].rows.cpu())
    for k in ("loc", "dist", "rotvec", "v3d", "j3d"):
        assert _max_err(a[k], b[k].cpu()) <= 1e-3 * max(a[k].abs().max().item(), 1.0), k
