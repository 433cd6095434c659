"""The standard residual stream (``tp_mode="ring"``) against the JAX package,
and the port's two streams against each other.

ViT: ViTConfig(32, 2, 2) at 56 x 56 on the weights of tests/test_torch_vit.py,
the JAX side with ``transposed_stream=False`` (its standard ``Block`` stream,
plain attention on the CPU), the port with ``tp_mode="ring"``, the one
switch it has for that stream. fp32: 1e-4 on the final-norm tokens, as the
channels-major test holds them. bf16: 0.1 and a mean error under 2e-2 (each
dense bias is added before the bf16 rounding by ``F.linear`` and after it by
the JAX package).

Whole slice: ``TinyConfig`` (ViT 32 wide, 2 deep, 56 x 56, K = 4 slots) in
fp32 with ``tp_mode="ring"`` on both sides, tempered reference weights:
detections equal, every output within 1e-4 of its largest magnitude but
j2d (1e-3: people near the camera divide by small depths), as
tests/test_torch_model.py holds the channels-major slice. One Adam train
step at epoch 0 against JAX ``make_train_step``: loss terms 1e-4, each
gradient 2e-3 relative, as tests/test_torch_train.py holds the
channels-major step.

The two streams of the port on the same seeded weights: fp32 outputs within
1e-5 relative (the same math in other summation orders); bf16 tokens within
2e-2 relative L2.

The standard stream's attention backward copies q, k, v, o and dO into K3's
channels-major layout padded to a multiple of 8 tokens (``kv_len`` = N): its
forward and gradients equal ``flash_bwd_reference_t`` on the unpadded
tensors within 1e-5 relative (fp32; the pad keys add exact zeros to the
softmax sums, the pad queries zero dO).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
from multihmr_tpu.io.checkpoint import convert_torch_checkpoint
from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR
from multihmr_tpu.models.vit import DINOv2ViT as JViT
from multihmr_tpu.train import loss as jloss
from multihmr_tpu.train import trainer as jtrainer
from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.config import ViTConfig
from multihmr_tpu_torch.io.convert import params_from_jax
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from multihmr_tpu_torch.models.vit import Block, DINOv2ViT, TBlock
from multihmr_tpu_torch.ops import attention as tatt
from multihmr_tpu_torch.train import trainer as ttrainer
from tests.test_checkpoint import make_reference_state_dict
from tests.test_torch_model import TOLS, _rel_err, _tiny_cfg
from tests.test_torch_train import BM_ARGS, LR, _batch, _cfg, _port_bm, _rel
from tests.test_torch_vit import CFG, GRID, _port, _random_params
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_standard_stream_vit_matches_jax(rng, dtype):
    params = _random_params(rng)
    x = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
    jvit = JViT(CFG, grid_size=GRID, dtype=jnp.dtype(dtype), transposed_stream=False)
    want = jax.jit(jvit.apply)(params, x)
    vit = _port(params, getattr(torch, dtype))
    std = DINOv2ViT(CFG, GRID, getattr(torch, dtype), tp_mode="ring")
    std.load_state_dict(vit.state_dict(), strict=True)
    assert all(isinstance(b, Block) for b in std.blocks)
    with torch.inference_mode():
        got = std(torch.from_numpy(x))
    for key in ("patch_tokens", "cls_token"):
        a, b = np.asarray(want[key], np.float32), got[key].float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(b, a, atol=1e-4, err_msg=key)
        else:
            np.testing.assert_allclose(b, a, atol=0.1, err_msg=key)
            assert np.abs(b - a).mean() < 2e-2, key


@pytest.mark.parametrize("tp_mode,block", [
    ("heads", TBlock), ("ring", Block), ("sequence", None)])
def test_stream_choice_follows_jax_rule(tp_mode, block):
    """The JAX rule at its default ``transposed_stream=True``: channels-major
    blocks unless ``tp_mode`` is "ring"; any other mode raises."""
    if block is None:
        with pytest.raises(ValueError, match="tp_mode"):
            DINOv2ViT(CFG, GRID, tp_mode=tp_mode)
        return
    vit = DINOv2ViT(CFG, GRID, tp_mode=tp_mode)
    assert vit.transposed == (tp_mode != "ring")
    assert all(isinstance(b, block) for b in vit.blocks)


@pytest.mark.parametrize("remat_policy", [None, "mlp", "block"])
def test_two_streams_agree(remat_policy):
    """Same seed → same weights on both streams; fp32 outputs and gradients
    within 1e-5 relative, with and without remat."""
    cfg = ViTConfig(embed_dim=128, depth=2, num_heads=2, layerscale_init=0.5)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 56, 56, 3)).astype(np.float32))
    # a fixed random projection of the outputs (the squares of final-norm
    # tokens would sum to a constant and leave only noise as gradient)
    w_p, w_c = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                for s in ((2, 16, 128), (2, 128)))
    outs, grads = {}, {}
    for tp_mode in ("heads", "ring"):
        vit = DINOv2ViT(cfg, GRID, torch.float32, remat_policy=remat_policy, tp_mode=tp_mode)
        vit.init_weights(torch.Generator().manual_seed(0))
        out = vit(x)
        ((out["patch_tokens"] * w_p).sum() + (out["cls_token"] * w_c).sum()).backward()
        outs[tp_mode] = out["patch_tokens"].detach()
        grads[tp_mode] = {k: p.grad for k, p in vit.named_parameters()}
    assert _rel(outs["ring"].numpy(), outs["heads"].numpy()) <= 1e-5
    assert sorted(grads["ring"]) == sorted(grads["heads"])
    for k, g in grads["heads"].items():
        assert _rel(grads["ring"][k].numpy(), g.numpy()) <= 1e-5, k


def test_two_streams_agree_bf16():
    cfg = ViTConfig(embed_dim=128, depth=2, num_heads=2, layerscale_init=0.5)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 56, 56, 3)).astype(np.float32))
    toks = {}
    for tp_mode in ("heads", "ring"):
        vit = DINOv2ViT(cfg, GRID, torch.bfloat16, tp_mode=tp_mode)
        vit.init_weights(torch.Generator().manual_seed(0))
        with torch.inference_mode():
            toks[tp_mode] = vit(x)["patch_tokens"].float()
    a, b = toks["heads"], toks["ring"]
    assert ((a - b).norm() / a.norm()).item() <= 2e-2


@pytest.fixture(scope="module")
def ring_pair():
    """(cfg, JAX params, JAX ring model, port ring model) on tempered weights."""
    cfg = _tiny_cfg()
    sd = make_reference_state_dict(cfg, np.random.default_rng(0))
    for k, v in sd.items():
        if k.endswith("weight") and v.ndim >= 2:
            sd[k] = (v / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
    params = convert_torch_checkpoint({"model_state_dict": sd}, cfg)
    jbm = jsynthetic()
    names = [f"j{i}" for i in range(jbm.num_output_joints)]
    jm = JMultiHMR(cfg, jbm, person_center_joint_names=names, tp_mode="ring")
    net = MultiHMRNet(cfg, tp_mode="ring")
    net.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    tm = MultiHMR(cfg, BodyModel.from_arrays(synthetic_body_model(), "cpu"), net=net,
                  person_center_joint_names=names)
    return cfg, params, jm, tm


def test_ring_slice_matches_jax(ring_pair, rng):
    cfg, params, jm, tm = ring_pair
    assert not tm.net.backbone.transposed
    x = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
    K = np.array([[[100.0, 0, 28], [0, 100, 28], [0, 0, 1]]] * 2, np.float32)
    a = jax.jit(lambda p, x, K: jm.forward(p, x, K, batch_mode="fused"))(params, x, K)
    with torch.inference_mode():
        b = tm.forward(torch.from_numpy(x), torch.from_numpy(K))
    for f in ("rows", "cols", "valid"):
        np.testing.assert_array_equal(getattr(b["det"], f).numpy(),
                                      np.asarray(getattr(a["det"], f)), err_msg=f)
    for k, tol in TOLS["tempered"].items():
        assert _rel_err(a[k], b[k].numpy()) <= tol, k
    pa = jm.extract_persons(a, fields=["v3d", "j2d"])
    pb = tm.extract_persons(b, fields=["v3d", "j2d"])
    assert [sorted(p) for img in pb for p in img] == [sorted(p) for img in pa for p in img]
    assert all(sorted(p) == ["j2d", "v3d"] for img in pb for p in img)


def test_ring_train_step_matches_jax():
    cfg = _cfg()
    jm = JMultiHMR(cfg, jsynthetic(**BM_ARGS), tp_mode="ring")
    params = jm.init_params(jax.random.PRNGKey(0))
    opt = optax.adam(LR)
    step = jtrainer.make_train_step(jm, opt, jloss.LossWeights(), donate=False)
    _, opt_state, j_terms = step(params, opt.init(params),
                                 {k: jnp.asarray(v) for k, v in _batch().items()}, 0)
    j_grads = params_from_jax(jax.device_get(
        jax.tree_util.tree_map(lambda m: m / 0.1, opt_state[0].mu)), cfg)

    net = MultiHMRNet(cfg, tp_mode="ring")
    net.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    model = MultiHMR(cfg, _port_bm(), net=net)
    terms = ttrainer.make_train_step(model, torch.optim.Adam(net.parameters(), lr=LR, eps=1e-8))(
        ttrainer.to_device(_batch(), "cpu"), 0)
    assert sorted(terms) == sorted(j_terms)
    for k in terms:
        assert _rel(terms[k].numpy(), j_terms[k]) <= 1e-4, k
    for name, p in net.named_parameters():
        assert _rel(p.grad.numpy(), j_grads[name].numpy()) <= 2e-3, name


@pytest.mark.parametrize("n,n_pad", [(37, 40), (40, 40)])
def test_standard_backward_on_padded_copy(rng, monkeypatch, n, n_pad):
    B, H, Dh = 2, 2, 64
    qkv = torch.from_numpy(rng.normal(size=(B, n, 3, H, Dh)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, n, H * Dh)).astype(np.float32))
    seen = []
    bwd = tatt._flash_bwd_impl_t

    def spy(q, *args, kv_len=None, **kw):
        seen.append((q.shape[-1], kv_len))
        return bwd(q, *args, kv_len=kv_len, **kw)

    monkeypatch.setattr(tatt, "_flash_bwd_impl_t", spy)
    a = qkv.clone().requires_grad_()
    out = tatt.flash_attention_qkv(a)
    out.backward(g)
    assert seen == [(n_pad, n)]
    q, k, v = (t.permute(0, 2, 3, 1) for t in qkv.unbind(2))  # [B, H, Dh, N]
    o, lse = tatt.mha_reference_t(q, k, v)
    assert _rel(out.detach().numpy(), o.permute(0, 3, 1, 2).reshape(B, n, H * Dh).numpy()) <= 1e-5
    do = g.reshape(B, n, H, Dh).permute(0, 2, 3, 1)
    want = tatt.flash_bwd_reference_t(q, k, v, o, lse, do)
    for i, w in enumerate(want):
        assert _rel(a.grad[:, :, i].permute(0, 2, 3, 1).numpy(), w.numpy()) <= 1e-5, i
