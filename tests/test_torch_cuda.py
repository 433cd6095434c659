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
TPU kernels do, and the outputs to bf16: 2^-9 relative each). The two-pass
K4a + K4b is the deterministic backward: two calls give bitwise-equal
gradients.

The bf16 K1, K3, K4a and K4b take only 16-byte token rows (a token count
and strides that are multiples of 8): their cases run at the ViT's
pre-padded lengths with junk past kv_len, (104, 97), (2312, 2305) and
(640, 577), K1's also at (4104, 4097), (8472, 8465), a kv_len that is a
multiple of 128 and one whose last 128-key tile has 33-64 keys, with 6
heads at batch 1, NaN past kv_len, q scaled x8 and a negative scale; an odd
token count or
channel stride raises; the fp32 paths
take any stride and keep odd token counts. K2 takes only
16-byte channel rows too: its cases run at aligned token counts (336 and
the 672 px stream's 2,312) at D = 128, 384 and 1024; an odd count or a
misaligned base raises. Its wide path (1024 < D <= 2048: two groups of 32
channels a warp) runs at D = 1056 (the last warp's second group absent),
1536 (ViT-g/14) and 2048, at the 896 px stream's 4,104 tokens and at 1,000,
both with a ragged last 32-token tile.
"""

import numpy as np
import pytest
import torch

from multihmr_tpu_torch.ops import attention, cuda_lib, norm
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

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
# K1 alone, bf16 (dtype, N, kv_len, heads, batch, junk past kv_len, q
# scale, softmax scale): the 896 and 1288 px streams (a last kv tile of 1
# and 17 keys), kv_len a multiple of 128 (no ragged tile) and one whose last
# tile takes 33-64 keys, 6 heads at batch 1 (672_S's smallest grid), NaN
# past kv_len, q scaled x8 (scores over a wide range, rows led by a few keys,
# for the exponentials split between the SFU and the FMA pipe), and a
# negative softmax scale (the kernel takes the max of the raw scores)
K1_CASES = ([(torch.bfloat16, n, kv, 4, 2, 100.0, 1.0, None)
             for n, kv in ((4104, 4097), (8472, 8465), (1032, 1024), (1088, 1065))]
            + [(torch.bfloat16, 2312, 2305, 6, 1, 100.0, 1.0, None),
               (torch.bfloat16, 4104, 4097, 4, 2, float("nan"), 1.0, None),
               (torch.bfloat16, 2312, 2305, 4, 2, 100.0, 8.0, None),
               (torch.bfloat16, 4104, 4097, 4, 2, float("nan"), 8.0, None),
               (torch.bfloat16, 2312, 2305, 4, 2, 100.0, 1.0, -0.125)])


@pytest.mark.parametrize("dtype,n,kv_len,heads,batch,junk,q_scale,scale",
                         [(*c, 4, 2, 100.0, 1.0, None) for c in FLASH_CASES] + K1_CASES)
def test_flash_attention_kernel(dev, dtype, n, kv_len, heads, batch, junk, q_scale, scale):
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((batch, 3 * heads * 64, n), device=dev, generator=g)
    qkv[:, :heads * 64] *= q_scale
    qkv = qkv.to(dtype)
    if kv_len is not None:
        qkv[..., kv_len:] = junk
    q, k, v = qkv.reshape(batch, 3, heads, 64, n).unbind(1)  # strided views, as in the ViT
    cuda_lib.reset_launches()
    out, lse = attention._flash_fwd_impl_t(q, k, v, scale=scale, kv_len=kv_len)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[attention.KERNEL] == 1
    # the plain version multiplies masked keys' v by 0: it gets zeros where
    # the kernel got NaN (nan_to_num leaves finite inputs as they are)
    ref_out, ref_lse = attention.mha_reference_t(*(t.nan_to_num(0.0) for t in (q, k, v)),
                                                 scale=scale, kv_len=kv_len)
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (batch, heads, n)
    lim = n if kv_len is None else kv_len
    _check_fwd(out[..., :lim], lse[..., :lim], ref_out[..., :lim], ref_lse[..., :lim])


def test_poly_exp2_error(dev, tmp_path):
    """The exponentials K1 runs on the FMA pipe (common.cuh poly_exp2) stay
    within 2^-12 of 2^x: P.V rounds P to bf16 (2^-9) in any case."""
    from multihmr_tpu_torch.tools.kernel_timing import poly_exp2_error

    errs = poly_exp2_error(tmp_path)
    assert max(errs.values()) <= 2.0 ** -12, errs


@pytest.mark.parametrize("entry", ["K1", "K3", "K4a", "K4b"])
def test_bf16_flash_rejects_unaligned_rows(dev, entry):
    """bf16 K1, K3, K4a and K4b copy 16-byte token rows: an odd channel
    stride (a view of a [.., 64, 105] buffer) raises, naming the rule;
    nothing pads."""
    buf = torch.zeros((1, 3, 2, 64, 105), device=dev, dtype=torch.bfloat16)
    q, k, v = buf[..., :104].unbind(1)
    lse = torch.zeros((1, 2, 104), device=dev)
    kernel = {"K3": attention.KERNEL_BWD, "K4a": attention.KERNEL_BWD_DQ,
              "K4b": attention.KERNEL_BWD_DKV}.get(entry)
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="multiples of 8"):
        if entry == "K1":
            attention._flash_fwd_impl_t(q, k, v)
        else:
            outs = [torch.empty((1, 2, 64, 104), device=dev, dtype=q.dtype) for _ in range(3)]
            attention._flash_bwd_t_cuda(kernel, q, k, v, q, lse, lse, 0.125, 104, *outs)
    assert not cuda_lib.LAUNCHES


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_backward_rejects_odd_token_count(dev, fused):
    """An odd N (97 tokens, 194-byte rows) raises in bf16 on either backward
    path (K3; K4a + K4b): pre-pad the stream to a multiple of 8 tokens."""
    q, k, v, o, lse, do = _bwd_inputs(dev, torch.bfloat16, 97, None)
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="multiples of 8"):
        attention._flash_bwd_impl_t(q, k, v, o, lse, do, fused=fused)
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
@pytest.mark.parametrize("batch", [1, 2])
def test_flash_attention_std_kernel(dev, dtype, n, layout, batch):
    q, k, v = _std_qkv(dev, dtype, n, batch=batch)
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
@pytest.mark.parametrize("n", [336, 2312])
@pytest.mark.parametrize("d", [128, 384, 1024])
def test_layernorm_kernel(dev, in_dtype, out_dtype, n, d):
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn((2, d, n), device=dev, generator=g) * 3 + 1).to(in_dtype)
    scale = torch.randn(d, device=dev, generator=g)
    bias = torch.randn(d, device=dev, generator=g)
    cuda_lib.reset_launches()
    y = norm.layernorm_cm(x, scale, bias, 1e-6, out_dtype)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[norm.KERNEL] == 1 and y.dtype == out_dtype
    assert cuda_lib.LAUNCHES[norm.KERNEL_WIDE] == (d > 1024)  # counted apart past 1,024
    ref = norm.layernorm_cm_reference(x, scale, bias, 1e-6, torch.float32)
    err = (y.float() - ref).abs()
    if out_dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert (err <= ref.abs() * 2 ** -7 + 1e-6).all()


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1000, 4104])
@pytest.mark.parametrize("d", [1056, 1536, 2048])
def test_layernorm_kernel_wide(dev, in_dtype, out_dtype, n, d):
    """K2's wide path against the plain version, as the narrow one."""
    test_layernorm_kernel(dev, in_dtype, out_dtype, n, d)


def test_layernorm_rejects(dev):
    x = torch.zeros((1, 8, 4), device=dev).transpose(1, 2)
    s = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        norm.layernorm_cm(x, s, s)


@pytest.mark.parametrize("case", ["odd N", "misaligned base"])
def test_layernorm_rejects_unaligned_rows(dev, case):
    """K2 moves 16-byte token vectors: a bf16 stream of 4,097 tokens, or a
    contiguous one whose base is 2 bytes past a 16-byte boundary, raises
    naming the rule; nothing pads or launches."""
    if case == "odd N":
        x = torch.zeros((1, 128, 4097), device=dev, dtype=torch.bfloat16)
    else:
        x = torch.zeros(128 * 336 + 1, device=dev, dtype=torch.bfloat16)[1:].view(1, 128, 336)
    s = torch.ones(128, device=dev)
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        norm.layernorm_cm(x, s, s)
    assert not cuda_lib.LAUNCHES


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


# K3 and K4a + K4b on FLASH_CASES (seed 0), and again in bf16 at the
# pre-padded lengths on other inputs (seed 1)
@pytest.mark.parametrize("dtype,n,kv_len,seed", [(*c, 0) for c in FLASH_CASES] + [
    (torch.bfloat16, n, kv, 1) for n, kv in ((104, 97), (2312, 2305))])
def test_flash_backward_kernels(dev, dtype, n, kv_len, seed):
    q, k, v, o, lse, do = _bwd_inputs(dev, dtype, n, kv_len, seed=seed)
    ref = attention.flash_bwd_reference_t(q, k, v, o, lse, do, kv_len=kv_len)
    cuda_lib.reset_launches()
    runs = [attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=fused)
            for fused in (False, True)]
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[attention.KERNEL_BWD] == 1
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


def test_two_pass_backward_is_deterministic(dev):
    """K4a + K4b at batch 2 into one packed [B, 3, H, 64, N] gradient (the
    training path's layout), NaN before the call: two calls give the same
    bits and write every lane; dk and dv are K3's bits (K4b is K3's kernel
    without the dq partial) and dq is K3's within the bf16 limit (K3 adds its
    dq in another order).

    (These inputs hold the two paths to each other, not to the plain
    backward: their pad queries carry junk q = 30 and a random dO, which
    the ViT never gives them, and the rounding of ds to bf16 that both
    kernels share with the TPU kernel puts their dk 1.5e-2 of its largest
    value from the fp32 plain backward here, beyond the 1e-2 limit that
    test_flash_backward_kernels holds on other seeds.)"""
    n, kv_len = 2312, 2305
    q, k, v, o, lse, do = _bwd_inputs(dev, torch.bfloat16, n, kv_len, seed=2)
    packed = [torch.full((2, 3) + q.shape[1:], float("nan"), dtype=q.dtype, device=dev)
              for _ in range(2)]
    for buf in packed:
        attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=False,
                                    out=buf.unbind(1))
    fused = attention._flash_bwd_impl_t(q, k, v, o, lse, do, kv_len=kv_len, fused=True)
    torch.cuda.synchronize()
    assert torch.equal(packed[0].view(torch.int16), packed[1].view(torch.int16))
    assert not packed[0].isnan().any()
    dq, dk, dv = packed[0].unbind(1)
    assert torch.equal(dk, fused[1]) and torch.equal(dv, fused[2])
    assert _rel(dq[..., :kv_len], fused[0][..., :kv_len]) <= BWD_TOL[torch.bfloat16]


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


def test_spans_on_card(dev):
    """A traced tiny ``folder_inference`` on the card: the stage spans hold
    device time, none of the program's spans has a copy on the device
    timeline, and the benchmark's four idle readings add up to the trace's
    window less its busy time (``portbench/trace.py::Trace.busy_s``, which
    would count such a copy) within 2 % of the window."""
    from multihmr_tpu_torch.config import ModelConfig, ViTConfig
    from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
    from multihmr_tpu_torch.bodymodel.core import BodyModel
    from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
    from multihmr_tpu_torch.parallel.infer import folder_inference
    from portbench import harness
    from portbench.trace import Trace

    cfg = ModelConfig(img_size=56, max_people=4, compute_dtype="float32",
                      vit_override=ViTConfig(embed_dim=128, depth=2, num_heads=2))
    net = MultiHMRNet(cfg).init_weights(torch.Generator().manual_seed(0)).eval().to(dev)
    model = MultiHMR(cfg, BodyModel.from_arrays(synthetic_body_model(), dev), net=net)
    rng = np.random.default_rng(0)
    images = [rng.normal(size=(56, 56, 3)).astype(np.float32) for _ in range(8)]
    K = np.array([[100.0, 0, 28], [0, 100, 28], [0, 0, 1]], np.float32)
    run = lambda: folder_inference(model, images, K, det_thresh=0.0, batch_size=2)  # noqa: E731
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    for name in ("vit", "head", "body"):
        spans = [e for e in host if e.name == "multihmr." + name]
        assert len(spans) == 4, name
        assert all(e.device_time_total > 0 for e in spans), name
    assert not [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name.startswith("multihmr.")]
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    tr = Trace(events, (hi - lo) / 1e6)
    ctx = {"trace": tr}
    idle = [harness.read_metric(m, ctx) for m in (
        "stack_idle_ms.infer", "upload_idle_ms.infer", "readback_idle_ms.infer",
        "other_idle_ms.infer")]
    assert None not in idle
    window_ms = tr.window_s * 1e3
    assert abs(4 * sum(idle) - (window_ms - tr.busy_s * 1e3)) <= 0.02 * window_ms
    assert harness.read_metric("fk_graph_pct.infer", ctx) == 100.0


@pytest.mark.parametrize("family,n", [("anny", 128), ("smplx", 16)])
def test_fk_graph_replays_the_loop(dev, family, n):
    """The forward kinematics under ``inference_mode`` replay a CUDA graph
    captured once a key: on two input sets through one key the outputs are
    bitwise the plain loop's (run with grad off outside ``inference_mode``),
    those of the first call are unchanged by the second (clones, not views
    of the graph's buffers), and a second shape makes a second capture.
    Anny (the synthetic 163-bone tree at the folder cell's 128 slots) passes
    the ``[..., :3, :3]`` view of its homogeneous rotations; the 55-bone
    tree here takes the QR factor as it comes, each 3 x 3 column-major,
    whose layout the graph's buffer has to keep (cuBLAS rounds a transposed
    operand otherwise: a few ulps down the chain)."""
    from multihmr_tpu_torch.bodymodel import core
    from multihmr_tpu_torch.bodymodel.anny import synthetic_anny_model
    from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model

    arrays = synthetic_anny_model() if family == "anny" else synthetic_body_model(num_joints=55)
    parents = tuple(int(p) for p in arrays["parents"])
    J = len(parents)

    def inputs(seed, n):
        g = torch.Generator().manual_seed(seed)
        R = torch.linalg.qr(torch.randn(n, J, 3, 3, generator=g)).Q
        joints = torch.randn(n, J, 3, generator=g).to(dev)
        if family == "smplx":
            assert R.stride()[-2:] == (1, 3)
            return R.to(dev), joints
        H = torch.zeros(n, J, 4, 4)
        H[..., :3, :3] = R
        H[..., 3, 3] = 1.0
        return H.to(dev)[..., :3, :3], joints

    sets = [inputs(0, n), inputs(1, n), inputs(2, n // 2)]
    with torch.no_grad():
        want = [core._forward_kinematics(R, t, parents) for R, t in sets]
    core._GRAPHS.clear()
    core.reset_fk()
    with torch.inference_mode():
        got = [core._forward_kinematics(R, t, parents) for R, t in sets[:2]]
        assert core.FK_GRAPH == {"captures": 1, "replays": 2}
        got.append(core._forward_kinematics(*sets[2], parents))
    torch.cuda.synchronize()
    assert core.FK_GRAPH == {"captures": 2, "replays": 3}
    assert core.FK == {"calls": 3, "steps": 3 * J}
    assert not torch.equal(want[0][0], want[1][0])
    for i, (g_out, w_out) in enumerate(zip(got, want)):
        for a, b in zip(g_out, w_out):
            assert a.shape == b.shape and torch.equal(a, b), (i, _max_err(a, b))


def test_folder_pipeline_on_card(dev, tmp_path):
    """``folder_inference``'s one-batch-ahead pipeline on the card, on the
    tiny model of ``test_spans_on_card`` over 8 batches of 2 distinct
    images: the persons are bitwise those of one forward per batch, read
    back at once; every host-to-device copy of the profiled run is from
    pinned memory, on a stream the kernels do not run on; and a copy runs
    under a kernel of an earlier batch. The tiny forward takes less device
    time than the host's work for a batch, so each forward here ends in a
    sleep kernel of 4e7 clock cycles (20-40 ms at the H100's clocks), as
    the 896_L forward's ~106 ms outlasts its host work; the sleep changes
    no output. A kernel that a batch's copy
    overlaps is an earlier batch's: the batch's own forward waits for it."""
    import json

    from multihmr_tpu_torch.config import ModelConfig, ViTConfig
    from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
    from multihmr_tpu_torch.bodymodel.core import BodyModel
    from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
    from multihmr_tpu_torch.parallel import infer

    cfg = ModelConfig(img_size=56, max_people=4, compute_dtype="float32",
                      vit_override=ViTConfig(embed_dim=128, depth=2, num_heads=2))
    net = MultiHMRNet(cfg).init_weights(torch.Generator().manual_seed(0)).eval().to(dev)
    model = MultiHMR(cfg, BodyModel.from_arrays(synthetic_body_model(), dev), net=net)
    rng = np.random.default_rng(0)
    images = [rng.normal(size=(56, 56, 3)).astype(np.float32) for _ in range(16)]
    K = np.array([[100.0, 0, 28], [0, 100, 28], [0, 0, 1]], np.float32)

    want = []
    with torch.inference_mode():
        for b in range(8):
            x = torch.from_numpy(np.stack(images[2 * b:2 * b + 2])).to(dev)
            Kb = torch.from_numpy(np.stack([K, K])).to(dev)
            want += model.start_persons(model.forward(x, Kb, det_thresh=0.0)).persons()

    plain = model.forward

    def slow_forward(*args, **kw):
        out = plain(*args, **kw)
        torch.cuda._sleep(40_000_000)
        return out

    model.forward = slow_forward

    def run():
        return infer.folder_inference(model, images, K, det_thresh=0.0, batch_size=2)

    run()
    torch.cuda.synchronize()
    infer.reset_pipeline()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = run()
        torch.cuda.synchronize()
    assert infer.PIPELINE == {"batches": 8, "ahead": 7}

    assert len(got) == len(want) == 16 and sum(map(len, got)) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.keys() == b.keys()
            for k in a:
                assert (a[k].dtype, a[k].shape, a[k].tobytes()) == (
                    b[k].dtype, b[k].shape, b[k].tobytes()), k

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    gpu = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy")]
    h2d = [e for e in gpu if e["name"].startswith("Memcpy HtoD")]
    kernels = [e for e in gpu if e["cat"] == "kernel"]
    assert len(h2d) == 16, [e["name"] for e in h2d]  # x and K of each batch
    assert all(e["name"] == "Memcpy HtoD (Pinned -> Device)" for e in h2d), {
        e["name"] for e in h2d}
    copy_streams = {e["args"]["stream"] for e in h2d}
    kernel_streams = {e["args"]["stream"] for e in kernels}
    assert len(copy_streams) == 1 and not copy_streams & kernel_streams, (
        copy_streams, kernel_streams)
    overlapped = [c for c in h2d if any(
        k["ts"] < c["ts"] + c["dur"] and c["ts"] < k["ts"] + k["dur"] for k in kernels)]
    assert overlapped, "no host-to-device copy ran under a kernel"
