"""K3/K4a/K4b port: the flash-attention backward, plain version against the JAX
package.

On the CPU ``_flash_bwd_impl_t`` runs ``flash_bwd_reference_t``; it is held to
the JAX ``_flash_bwd_impl_t`` run as the JAX tests run it (Pallas interpret
mode), fused (K3) and two-pass (K4a + K4b), on the same fp32 inputs from a
seed with o and lse from the JAX forward. Tolerance: each gradient's max
error at most 2e-5 of its largest magnitude (fp32 sums over <= 384 keys in
other orders; the Pallas kernels work in exp2 with q pre-scaled). The
kernels themselves are held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multihmr_tpu.ops import attention as jatt
from multihmr_tpu_torch.ops import attention as tatt
from multihmr_tpu_torch.ops import cuda_lib
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

TOL = 2e-5


def _inputs(rng, n, kv_len=None, B=1, H=2, Dh=64):
    q, k, v, do = (rng.normal(size=(B, H, Dh, n)).astype(np.float32) for _ in range(4))
    if kv_len is not None:  # pre-padded stream: junk (not zeros) past kv_len
        for t in (q, k, v):
            t[..., kv_len:] = rng.normal(size=t[..., kv_len:].shape) * 20
    return q, k, v, do


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n,kv_len", [(37, None), (300, None), (384, 300), (104, 97)])
def test_plain_backward_matches_pallas(rng, fused, n, kv_len):
    """(384, 300) is the JAX kernel's own pre-padded length; (104, 97) the
    port's (a multiple of 8), which the JAX kernel does not take: there it
    runs on the 97 true tokens and the port's true lanes are compared. As in
    the model, the pad queries' dO is zero (their lanes are dropped) and
    their o and lse are the forward's."""
    q, k, v, do = _inputs(rng, n, kv_len)
    own = kv_len is None or jatt.transposed_padded_len(kv_len) == n
    lim = n if kv_len is None else kv_len
    if not own:
        do[..., lim:] = 0
    jq, jk, jv, jdo = (jnp.asarray(a if own else a[..., :lim]) for a in (q, k, v, do))
    jkv = kv_len if own else None
    o, lse = jatt._flash_fwd_impl_t(jq, jk, jv, interpret=True, kv_len=jkv)
    want = jatt._flash_bwd_impl_t(jq, jk, jv, o, lse, jdo, interpret=True,
                                  kv_len=jkv, fused=fused)
    if not own:
        jo = np.asarray(o)
        o, lse = tatt.mha_reference_t(*map(torch.from_numpy, (q, k, v)), kv_len=kv_len)
        assert _rel_err(o.numpy()[..., :lim], jo) <= TOL
    cuda_lib.reset_launches()
    got = tatt._flash_bwd_impl_t(*map(torch.from_numpy, (q, k, v)),
                                 torch.from_numpy(np.asarray(o)),
                                 torch.from_numpy(np.asarray(lse)), torch.from_numpy(do),
                                 kv_len=kv_len, fused=fused)
    assert not cuda_lib.LAUNCHES  # the CPU never reaches a kernel
    for name, a, b in zip("qkv", got, want):
        assert a.shape == q.shape and a.dtype == torch.float32
        a = a.numpy()[..., :lim] if not own else a.numpy()
        assert _rel_err(a, b) <= TOL, (name, _rel_err(a, b))
    if kv_len is not None:  # the pad-lane invariant: dk, dv exact zeros
        for t in got[1:]:
            assert not t[..., kv_len:].any()


def test_packed_output(rng):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(rng, 50))
    o, lse = tatt._flash_fwd_impl_t(q, k, v)
    packed = torch.empty((1, 3) + q.shape[1:])
    got = tatt._flash_bwd_impl_t(q, k, v, o, lse, do, out=packed.unbind(1))
    want = tatt.flash_bwd_reference_t(q, k, v, o, lse, do)
    for a, b, c in zip(got, packed.unbind(1), want):
        assert a.data_ptr() == b.data_ptr()
        torch.testing.assert_close(b, c, rtol=0, atol=0)


@pytest.mark.parametrize("kv_len", [None, 100])
def test_autograd_matches_jax_vjp(rng, kv_len):
    n = 128 if kv_len else 77
    q, k, v, do = _inputs(rng, n, kv_len)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if kv_len is not None:  # the JAX kernel's pre-padded length for kv_len
        assert jatt.transposed_padded_len(kv_len) == n
    out_j, vjp = jax.vjp(lambda a, b, c: jatt.flash_attention_t(a, b, c, None, True, kv_len),
                         jq, jk, jv)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tatt.flash_attention_t(tq, tk, tv, kv_len=kv_len)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert _rel_err(out.detach().numpy(), out_j) <= TOL
    for name, a, b in zip("qkv", got, want):
        assert _rel_err(a.numpy(), b) <= TOL, (name, _rel_err(a.numpy(), b))


@pytest.mark.parametrize("kv_len", [None, 5])
def test_gradcheck_fp64(kv_len):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn((1, 3, 2, 4, 7), dtype=torch.float64, generator=gen).requires_grad_()

    def fn(qkv):
        return tatt.flash_attention_qkv_t(qkv, kv_len=kv_len)

    assert torch.autograd.gradcheck(fn, (qkv,), eps=1e-6, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_forward_without_graph_skips_function(rng, mode):
    # inference takes the forward directly: same values, no autograd node
    qkv = torch.from_numpy(np.stack(_inputs(rng, 60)[:3], 1)).requires_grad_()
    want = tatt.flash_attention_qkv_t(qkv)
    assert want.grad_fn is not None
    with getattr(torch, mode)():
        got = tatt.flash_attention_qkv_t(qkv)
    assert got.grad_fn is None
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)


def test_other_devices_raise():
    q = torch.empty((1, 2, 64, 8), device="meta")
    lse = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tatt._flash_bwd_impl_t(q, q, q, q, lse, q)
