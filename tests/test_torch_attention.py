"""K1 port: channels-major attention, plain version against the JAX package.

On the CPU ``_flash_fwd_impl_t`` runs its plain version; it is held to the
JAX transposed flash kernel run as the JAX tests run it (Pallas interpret
mode) and to the JAX ``mha_reference_t``. Inputs are fp32, made from a seed.
Tolerance 2e-5 on out and lse: fp32 softmax-weighted sums of O(1) values
over <= 384 keys, accumulated in different orders (the Pallas kernel folds
scale*log2(e) into q and works in exp2). The kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multihmr_tpu.ops import attention as jatt
from multihmr_tpu_torch.ops import attention as tatt
from multihmr_tpu_torch.ops import cuda_lib
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

TOL = 2e-5


def _qkv(rng, B, H, N, Dh=64):
    return [rng.normal(size=(B, H, Dh, N)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [100, 300])
def test_plain_matches_pallas_kernel(rng, n):
    q, k, v = _qkv(rng, 1, 2, n)
    out_j, lse_j = jatt._flash_fwd_impl_t(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    out_t, lse_t = tatt._flash_fwd_impl_t(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=TOL)
    ref = jatt.mha_reference_t(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("kv_len", [129, 200])
def test_kv_len_masks_junk(rng, kv_len):
    # stream pre-padded to the JAX kernel's length; junk (not zeros) past kv_len
    n = jatt.transposed_padded_len(kv_len)
    q, k, v = _qkv(rng, 2, 2, n)
    for t in (k, v):
        t[..., kv_len:] = rng.normal(size=t[..., kv_len:].shape) * 50
    out_j, lse_j = jatt._flash_fwd_impl_t(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, kv_len=kv_len)
    out_t, lse_t = tatt._flash_fwd_impl_t(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), kv_len=kv_len)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=TOL)
    # the junk is really masked: same rows as attention over the true keys
    cut = [torch.from_numpy(np.ascontiguousarray(t[..., :kv_len])) for t in (q, k, v)]
    out_c, _ = tatt.mha_reference_t(*cut)
    np.testing.assert_allclose(out_t.numpy()[..., :kv_len], out_c.numpy(), atol=TOL)


def test_explicit_scale(rng):
    q, k, v = _qkv(rng, 1, 1, 64)
    ref = jatt.mha_reference_t(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.05)
    out = tatt.flash_attention_t(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), scale=0.05)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


def test_cpu_tensor_does_not_launch(rng):
    cuda_lib.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 2, 50))
    tatt.flash_attention_t(q, k, v)
    assert cuda_lib.LAUNCHES[tatt.KERNEL] == 0


def test_other_devices_raise():
    q = torch.empty((1, 2, 64, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tatt._flash_fwd_impl_t(q, q, q)


@pytest.mark.parametrize("case,ok", [
    ("aligned", True), ("odd token count", False), ("odd channel stride", False),
    ("token stride 2", False), ("base not 16-byte aligned", False)])
def test_rows16_rule(case, ok):
    """The bf16 K1/K3 alignment rule (checked before a CUDA launch; the
    check itself reads only shapes, strides and pointers)."""
    buf = torch.zeros((2, 3, 4, 64, 112), dtype=torch.bfloat16)
    q = {"aligned": buf[:, 0, ..., :104],
         "odd token count": buf[:, 0, ..., :97],
         "odd channel stride": torch.zeros((2, 4, 64, 105), dtype=torch.bfloat16)[..., :104],
         "token stride 2": buf[:, 0, ..., ::2],
         "base not 16-byte aligned": buf[:, 0, ..., 1:105]}[case]
    if ok:
        tatt._check_rows16("K1", q=q)
    else:
        with pytest.raises(ValueError, match="multiples of 8"):
            tatt._check_rows16("K1", q=q)


ROWS16_CASES = ["aligned", "odd token count", "odd channel stride", "token stride 2",
                "base not 16-byte aligned"]


def _rows16_case(case, n_tok=112):
    buf = torch.zeros((2, 3, 4, 64, n_tok), dtype=torch.bfloat16)
    return {"aligned": buf[:, 0, ..., :104],
            "odd token count": buf[:, 0, ..., :97],
            "odd channel stride": torch.zeros((2, 4, 64, 105), dtype=torch.bfloat16)[..., :104],
            "token stride 2": buf[:, 0, ..., ::2],
            "base not 16-byte aligned": buf[:, 0, ..., 1:105]}[case]


@pytest.mark.parametrize("kernel", [tatt.KERNEL_BWD_DQ, tatt.KERNEL_BWD_DKV])
@pytest.mark.parametrize("case", ROWS16_CASES)
def test_rows16_rule_two_pass(kernel, case):
    """The bf16 K4a and K4b copy 16-byte token rows too, under K1's and
    K3's rule and message, which names the kernel's entry and every kernel
    the rule binds."""
    q = _rows16_case(case)
    if case == "aligned":
        tatt._check_rows16(kernel, q=q)
        return
    with pytest.raises(ValueError, match="multiples of 8") as err:
        tatt._check_rows16(kernel, q=q)
    assert kernel in str(err.value) and "K4a" in str(err.value) and "K4b" in str(err.value)


class _LibraryReached(Exception):
    pass


@pytest.mark.parametrize("kernel", [tatt.KERNEL_BWD, tatt.KERNEL_BWD_DQ, tatt.KERNEL_BWD_DKV])
@pytest.mark.parametrize("case", ROWS16_CASES)
def test_bwd_checks_rows_before_the_library(kernel, case, monkeypatch):
    """Every bf16 mode of the backward entry (K3, K4a, K4b) checks the row
    rule before it reaches cuda_lib: on tensors that break it, it raises the
    rule and never loads the library; on aligned ones it goes on to it. The
    wrapper reads only shapes, strides and pointers, so CPU tensors do."""
    def library():
        raise _LibraryReached
    monkeypatch.setattr(cuda_lib, "library", library)
    q = _rows16_case(case)
    B, H, _, N = q.shape
    lse, dd = torch.zeros((B, H, N)), torch.zeros((B, H, N))
    outs = [torch.empty(q.shape, dtype=q.dtype) for _ in range(3)]
    args = (q, q, q, q, lse, dd, 0.125, N, *outs)
    if case == "aligned":
        with pytest.raises(_LibraryReached):
            tatt._flash_bwd_t_cuda(kernel, *args)
    else:
        with pytest.raises(ValueError, match="multiples of 8"):
            tatt._flash_bwd_t_cuda(kernel, *args)
