"""K5 port: standard-layout attention, the plain paths against the JAX package.

On the CPU every entry runs its plain version. The port keeps only the
entries its ViT calls (``_flash_fwd_std``, ``flash_attention_qkv`` and
``attention_qkv`` on a packed ``[B, N, 3, H, Dh]`` projection); the JAX
package's per-tensor entries are each held to them through ``_packed``, on
the same seeded fp32 inputs, the JAX flash entries run as the JAX tests run
them (Pallas interpret mode). Tolerances:

  * forward out and lse: 2e-5 (fp32 softmax-weighted sums of O(1) values
    over <= 200 keys in other orders; the Pallas kernel works in exp2 with
    scale * log2(e) folded into q);
  * gradients of sum(tanh(out)) through the autograd Functions against
    ``jax.grad`` of the JAX custom-VJP entries: 2e-4, as
    tests/test_attention_grad.py holds the JAX flash VJP to plain autodiff.

The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 12).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multihmr_tpu.ops import attention as jatt
from multihmr_tpu_torch.ops import attention as tatt
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

TOL = 2e-5
GRAD_TOL = 2e-4


def _qkv(rng, B=1, H=2, N=200, Dh=64):
    return [rng.normal(size=(B, H, N, Dh)).astype(np.float32) for _ in range(3)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _packed(ts):
    """q, k, v ``[B, H, N, Dh]`` → the ViT's packed ``[B, N, 3, H, Dh]``."""
    return torch.stack([t.transpose(1, 2) for t in ts], 2)


def _split_heads(out, H):
    """``[B, N, H * Dh]`` → ``[B, H, N, Dh]``."""
    B, N, _ = out.shape
    return out.reshape(B, N, H, -1).transpose(1, 2)


@pytest.mark.parametrize("n", [200, 77])
def test_flash_fwd_impl_plain_matches_pallas(rng, n):
    """K5's plain path against the JAX kernel ``_flash_fwd_impl``, whose
    output is ``[B, H, Dh, N]``."""
    qkv = _qkv(rng, B=2, N=n)
    out_j, lse_j = jatt._flash_fwd_impl(*_j(qkv), interpret=True)
    out_t, lse_t = tatt._flash_fwd_std(*_t(qkv))
    assert out_t.shape == (2, 2, n, 64) and lse_t.shape == (2, 2, n)
    np.testing.assert_allclose(out_t.transpose(-1, -2).numpy(), np.asarray(out_j), atol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=TOL)


def test_mha_reference_matches_jax(rng):
    qkv = _qkv(rng)
    want = jatt.mha_reference(*_j(qkv))
    np.testing.assert_allclose(tatt.mha_reference(*_t(qkv)).numpy(), np.asarray(want), atol=TOL)
    # bf16 inputs: scores in bf16, softmax in fp32, probabilities cast to bf16
    b16 = [a.astype(jnp.bfloat16) for a in _j(qkv)]
    want = np.asarray(jatt.mha_reference(*b16), np.float32)
    got = tatt.mha_reference(*(t.to(torch.bfloat16) for t in _t(qkv))).float().numpy()
    np.testing.assert_allclose(got, want, atol=3e-2)  # bf16 products summed in other orders
    assert np.abs(got - want).mean() < 2e-3


@pytest.mark.parametrize("transposed_out", [False, True])
def test_flash_attention_matches_jax(rng, transposed_out):
    """JAX ``flash_attention`` (either output layout) against K5's entry
    writing that layout."""
    qkv = _qkv(rng)
    want = jatt.flash_attention(*_j(qkv), interpret=True, transposed_out=transposed_out)
    buf = torch.empty((1, 2, 64, 200)).transpose(2, 3) if transposed_out else None
    got, _ = tatt._flash_fwd_std(*_t(qkv), out=buf)
    if transposed_out:
        got = got.transpose(-1, -2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_merged_entries_match_jax(rng):
    """The JAX package's merged and per-head entries against the port's
    packed ones: ``flash_attention_qkv`` (the autograd Function's forward
    with a graph recorded, the plain forward without) and ``attention_qkv``
    (plain on the CPU, as the JAX dispatchers off the TPU)."""
    qkv = _qkv(rng, B=2)
    packed = _packed(_t(qkv))
    with torch.no_grad():
        fwd = tatt.flash_attention_qkv(packed)
    ported = {"flash_attention_qkv": tatt.flash_attention_qkv(packed.clone().requires_grad_()),
              "flash_attention_qkv, no graph": fwd, "attention_qkv": tatt.attention_qkv(packed)}
    wants = {"flash_attention_merged": jatt.flash_attention_merged(*_j(qkv), None, True),
             "attention_merged": jatt.attention_merged(*_j(qkv))}
    for name, want in wants.items():
        assert want.shape == (2, 200, 128)
        for got_name, got in ported.items():
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL,
                                       err_msg=f"{got_name} vs {name}")
    want = jatt.multi_head_attention(*_j(qkv))
    np.testing.assert_allclose(_split_heads(tatt.attention_qkv(packed), 2).numpy(),
                               np.asarray(want), atol=TOL)


def _jax_grads(fn, qkv):
    return jax.grad(lambda q, k, v: jnp.sum(jnp.tanh(fn(q, k, v))), argnums=(0, 1, 2))(*_j(qkv))


@pytest.mark.parametrize("n", [160, 200])
def test_merged_grad_matches_jax(rng, n):
    """The packed autograd Function's backward (the layout copies around
    the plain K3 backward) against ``jax.grad`` of the JAX merged entry."""
    qkv = _qkv(rng, N=n)
    want = _jax_grads(lambda q, k, v: jatt.flash_attention_merged(q, k, v, None, True), qkv)
    ts = [t.requires_grad_() for t in _t(qkv)]
    torch.tanh(tatt.flash_attention_qkv(_packed(ts))).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_TOL)


def test_trainable_grad_matches_jax(rng):
    """The same backward against ``jax.grad`` of the JAX per-head entry."""
    qkv = _qkv(rng)
    want = _jax_grads(lambda q, k, v: jatt.flash_attention_trainable(q, k, v, None, True), qkv)
    ts = [t.requires_grad_() for t in _t(qkv)]
    torch.tanh(_split_heads(tatt.flash_attention_qkv(_packed(ts)), 2)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_TOL)


def test_packed_gradient_is_one_tensor(rng):
    """The packed Function returns one [B, N, 3, H, Dh] gradient, equal to
    autograd through the plain attention."""
    qkv = torch.from_numpy(rng.normal(size=(2, 50, 3, 2, 64)).astype(np.float32))
    a, b = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
    torch.tanh(tatt.flash_attention_qkv(a)).sum().backward()
    torch.tanh(tatt._merge_heads(tatt.mha_reference(*tatt._unpack(b)))).sum().backward()
    assert a.grad.shape == qkv.shape and a.grad.is_contiguous()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=GRAD_TOL)


def test_inference_skips_the_function(rng):
    qkv = torch.from_numpy(rng.normal(size=(1, 30, 3, 2, 64)).astype(np.float32))
    with torch.no_grad():
        out = tatt.flash_attention_qkv(qkv)
    assert out.grad_fn is None and out.shape == (1, 30, 128)
    np.testing.assert_allclose(out.numpy(), tatt.attention_qkv(qkv).numpy(), atol=TOL)


def test_out_view_is_written(rng):
    q, k, v = _t(_qkv(rng, N=40))
    buf = torch.full((1, 2, 64, 40), float("nan"))
    out, _ = tatt._flash_fwd_std(q, k, v, out=buf.transpose(2, 3))
    assert out.data_ptr() == buf.data_ptr() and not buf.isnan().any()
    np.testing.assert_allclose(buf.transpose(2, 3).numpy(),
                               tatt.flash_fwd_reference(q, k, v)[0].numpy(), atol=0)


def test_std_rejects_other_devices():
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tatt._flash_fwd_std(q, q, q)
