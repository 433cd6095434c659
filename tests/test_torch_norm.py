"""K2 port: channels-major LayerNorm, plain version against the JAX package.

On the CPU ``layernorm_cm`` runs its plain version; it is held to the JAX
Pallas kernel in interpret mode. fp32 output: 2e-5 (fp32 statistics over
D = 64 channels of O(3) values, summed in different orders). bf16 output: at
most one bf16 ulp apart (2^-7 relative), since both round the same fp32
value at the final cast and the fp32 values may differ in the last bits.

Backward (torch ops on both devices, no kernel) against ``jax.vjp`` of the
JAX ``layernorm_cm``, which takes its analytic ``_ln_bwd`` on the CPU: fp32
dx, dscale and dbias within 2e-5 of each one's largest magnitude (fp32 sums
over D = 64 channels and B * N tokens in other orders); bf16 x gives bf16
dx, at most one bf16 ulp apart (2^-7 relative to the largest |dx|).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multihmr_tpu.ops import norm as jnorm
from multihmr_tpu_torch.ops import cuda_lib
from multihmr_tpu_torch.ops import norm as tnorm


def _inputs(rng, n, D=64):
    x = (rng.normal(size=(2, D, n)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(D,)).astype(np.float32)
    bias = rng.normal(size=(D,)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("n", [256, 333])
def test_plain_matches_pallas_fp32(rng, n):
    x, scale, bias = _inputs(rng, n)
    want = jnorm._ln_fwd_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                1e-6, jnp.float32, interpret=True)
    got = tnorm.layernorm_cm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias), 1e-6, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_pallas_bf16_out(rng, in_dtype):
    x, scale, bias = _inputs(rng, 160)
    xt = torch.from_numpy(x).to(in_dtype)
    xj = jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if in_dtype == torch.bfloat16 else jnp.float32)
    want = jnorm._ln_fwd_pallas(xj, jnp.asarray(scale), jnp.asarray(bias),
                                1e-6, jnp.bfloat16, interpret=True)
    got = tnorm.layernorm_cm(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                             1e-6, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-6)


def test_cpu_tensor_does_not_launch(rng):
    cuda_lib.reset_launches()
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(rng, 40))
    tnorm.layernorm_cm(x, scale, bias)
    assert cuda_lib.LAUNCHES[tnorm.KERNEL] == 0


def test_other_devices_raise():
    x = torch.empty((1, 8, 4), device="meta")
    s = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tnorm.layernorm_cm(x, s, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_matches_jax_vjp(rng, dtype):
    x, scale, bias = _inputs(rng, 150)
    g = rng.normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(xt.float().numpy()).astype(jdt)
    _, vjp = jax.vjp(lambda a, s, b: jnorm.layernorm_cm(a, s, b, 1e-6, jdt),
                     xj, jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g).astype(jdt))
    xt.requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = tnorm.layernorm_cm(xt, st, bt, 1e-6, dtype)
    got = torch.autograd.grad(y, (xt, st, bt), torch.from_numpy(g).to(dtype))
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        tol = 2 ** -7 if (name == "dx" and dtype == torch.bfloat16) else 2e-5
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), name


def test_backward_gradcheck_fp64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 3), dtype=torch.float64, generator=gen).requires_grad_()
    s = torch.randn(5, dtype=torch.float64, generator=gen).requires_grad_()
    b = torch.randn(5, dtype=torch.float64, generator=gen).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, s, b: tnorm.layernorm_cm(x, s, b, 1e-6, torch.float64), (x, s, b))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_forward_without_graph_skips_function(rng, mode):
    # inference takes the forward directly: same values, no autograd node
    x, scale, bias = (torch.from_numpy(a).requires_grad_() for a in _inputs(rng, 70))
    want = tnorm.layernorm_cm(x, scale, bias)
    assert want.grad_fn is not None
    with getattr(torch, mode)():
        got = tnorm.layernorm_cm(x, scale, bias)
    assert got.grad_fn is None
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)
