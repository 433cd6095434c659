"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card and skip without one. The machine with the card
has no jax, and tests/conftest.py imports it, so run them there with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 kernels against the fp32 plain version, 1e-5 on out (fp32
sums in another order) and 1e-5 on lse. bf16 kernels against the plain
version computed in fp32 from the same bf16 inputs and rounded to bf16: out
|out - ref| <= 2^-7 |ref| + 2^-5 rms(ref) elementwise (one bf16 ulp where
the two roundings fall apart, plus the kernel's rounding of P to bf16 before
P.V, an error of the scale of the outputs), as chip_smoke.py phases 3 and 12
hold them; lse 5e-5 (fp32 statistics from fp32
scores on both sides). The standard-layout forward K5 is held to the same
tolerances. LayerNorm: fp32 out 1e-5; bf16 out one bf16 ulp of |y| <= 8
(2^-7 relative).

Flash backward (K3, K4a + K4b) against the plain fp32 backward on the same
inputs, each gradient's max error relative to its largest magnitude: fp32
1e-4 (fp32 sums in other orders, dq's by atomic adds in a varying order);
bf16 1e-2 (the kernels round p and ds to bf16 before their products, as the
TPU kernels do, and the outputs to bf16: 2^-9 relative each).

The bf16 K1 and K3 take only 16-byte token rows (a token count and strides
that are multiples of 8): their cases run at the ViT's pre-padded lengths
with junk past kv_len, (104, 97), (2312, 2305) and (640, 577); the fp32
paths and K4a/K4b take any stride and keep odd token counts.
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


def _check_fwd(out, lse, ref_out, ref_lse):
    """A flash forward's out and lse against its plain version's."""
    if out.dtype == torch.float32:
        assert _max_err(out, ref_out) <= 1e-5
        assert _max_err(lse, ref_lse) <= 1e-5
    else:
        ref = ref_out.float()
        err = (out.float() - ref).abs()
        beyond = (err - 2 ** -7 * ref.abs()).max().item()
        floor = 2 ** -5 * ref.square().mean().sqrt().item()
        assert beyond <= floor, (err.max().item(), beyond, floor)
        assert _max_err(lse, ref_lse) <= 5e-5


# (dtype, N, kv_len): bf16 on pre-padded lengths, fp32 at odd ones
FLASH_CASES = ([(torch.bfloat16, n, kv) for n, kv in ((104, 97), (2312, 2305), (640, 577))]
               + [(torch.float32, n, kv) for n, kv in ((97, None), (2305, None), (640, 577))])


@pytest.mark.parametrize("dtype,n,kv_len", FLASH_CASES)
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
    _check_fwd(out[..., :lim], lse[..., :lim], ref_out[..., :lim], ref_lse[..., :lim])


@pytest.mark.parametrize("entry", ["K1", "K3"])
def test_bf16_flash_rejects_unaligned_rows(dev, entry):
    """bf16 K1 and K3 copy 16-byte token rows: an odd channel stride (a view
    of a [.., 64, 105] buffer) raises, naming the rule; nothing pads."""
    buf = torch.zeros((1, 3, 2, 64, 105), device=dev, dtype=torch.bfloat16)
    q, k, v = buf[..., :104].unbind(1)
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="multiples of 8"):
        if entry == "K1":
            attention._flash_fwd_impl_t(q, k, v)
        else:
            lse = torch.zeros((1, 2, 104), device=dev)
            attention._flash_bwd_impl_t(q, k, v, q, lse, q)
    assert not cuda_lib.LAUNCHES


def test_flash_attention_rejects(dev):
    q = torch.zeros((1, 2, 32, 16), device=dev)
    with pytest.raises(ValueError, match="Dh=64"):
        attention._flash_fwd_impl_t(q, q, q)
    q = torch.zeros((1, 2, 64, 16), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        attention._flash_fwd_impl_t(q, q, q)


def _std_qkv(dev, dtype, n, batch=2, heads=4, seed=0):
    """q, k, v as the standard-stream ViT makes them: [B, H, N, 64] views of
    one [B, N, 3 * H * 64] projection output."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((batch, n, 3 * heads * 64), device=dev, generator=g).to(dtype)
    return qkv.reshape(batch, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)


# output layouts K5 writes: the merged [B, N, H, 64] buffer (its default),
# a contiguous [B, H, N, 64] and the JAX kernel's [B, H, 64, N]
STD_OUT = {
    "merged": lambda B, H, N, dt, dev: torch.empty((B, N, H, 64), dtype=dt, device=dev).transpose(1, 2),
    "bhnd": lambda B, H, N, dt, dev: torch.empty((B, H, N, 64), dtype=dt, device=dev),
    "bhdn": lambda B, H, N, dt, dev: torch.empty((B, H, 64, N), dtype=dt, device=dev).transpose(2, 3),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [97, 640, 2305])
@pytest.mark.parametrize("layout", sorted(STD_OUT))
def test_flash_attention_std_kernel(dev, dtype, n, layout):
    q, k, v = _std_qkv(dev, dtype, n)
    B, H = q.shape[:2]
    out = STD_OUT[layout](B, H, n, dtype, dev)
    cuda_lib.reset_launches()
    got, lse = attention._flash_fwd_std(q, k, v, out=out)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[attention.KERNEL_STD] == 1 and got.data_ptr() == out.data_ptr()
    ref_out, ref_lse = attention.flash_fwd_reference(q, k, v)
    _check_fwd(got, lse, ref_out, ref_lse)


def test_flash_attention_std_rejects(dev):
    q = torch.zeros((1, 2, 16, 32), device=dev)
    with pytest.raises(ValueError, match="Dh=64"):
        attention._flash_fwd_std(q, q, q)
    q = torch.zeros((1, 2, 64, 16), device=dev).transpose(-1, -2)  # channel stride 16
    with pytest.raises(ValueError, match="16-byte"):
        attention._flash_fwd_std(q, q, q)
    q = torch.zeros((1, 2, 16, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        attention._flash_fwd_std(q, q, q)


def test_flash_attention_qkv_grad(dev):
    """K5 forward and K3 backward through the packed autograd Function
    against autograd through the plain attention, fp32."""
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn((2, 300, 3, 4, 64), device=dev, generator=g)
    w = torch.randn((2, 300, 256), device=dev, generator=g)
    a = qkv.clone().requires_grad_()
    b = qkv.clone().requires_grad_()
    cuda_lib.reset_launches()
    (attention.attention_qkv(a) * w).sum().backward()
    assert cuda_lib.LAUNCHES[attention.KERNEL_STD] == 1
    assert cuda_lib.LAUNCHES[attention.KERNEL_BWD] == 1
    q, k, v = b.permute(2, 0, 3, 1, 4).unbind(0)
    (attention._merge_heads(attention.mha_reference(q, k, v)) * w).sum().backward()
    assert _rel(a.grad, b.grad) <= BWD_TOL[torch.float32]


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


# K3 and K4a + K4b on FLASH_CASES; K4a + K4b alone in bf16 at odd lengths
@pytest.mark.parametrize("dtype,n,kv_len", FLASH_CASES + [
    (torch.bfloat16, n, kv) for n, kv in ((97, None), (2305, None))])
def test_flash_backward_kernels(dev, dtype, n, kv_len):
    q, k, v, o, lse, do = _bwd_inputs(dev, dtype, n, kv_len)
    ref = attention.flash_bwd_reference_t(q, k, v, o, lse, do, kv_len=kv_len)
    with_k3 = dtype == torch.float32 or n % 8 == 0
    cuda_lib.reset_launches()
    runs = [attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=False)]
    if with_k3:
        runs.append(attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=True))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[attention.KERNEL_BWD] == int(with_k3)
    assert cuda_lib.LAUNCHES[attention.KERNEL_BWD_DQ] == 1
    assert cuda_lib.LAUNCHES[attention.KERNEL_BWD_DKV] == 1
    for grads in runs:
        for name, a, r in zip("qkv", grads, ref):
            assert a.dtype == dtype and a.shape == q.shape, name
            assert _rel(a, r) <= BWD_TOL[dtype], (name, _rel(a, r))
        if kv_len is not None:  # keys past kv_len: exact zeros
            for t in grads[1:]:
                assert not t[..., kv_len:].any()


def test_flash_backward_into_packed_gradient(dev):
    q, k, v, o, lse, do = _bwd_inputs(dev, torch.bfloat16, 304, None)
    packed = torch.empty((2, 3) + q.shape[1:], dtype=q.dtype, device=dev)
    out = attention._flash_bwd_impl_t(q, k, v, o, lse, do, out=packed.unbind(1))
    want = attention._flash_bwd_impl_t(q, k, v, o, lse, do)
    for a, b, c in zip(out, packed.unbind(1), want):
        assert a.data_ptr() == b.data_ptr()
        # dk, dv equal; dq may differ by a bf16 ulp (atomic adds in another order)
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
