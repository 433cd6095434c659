"""Training port against the JAX package on the tiny configuration.

``TinyConfig`` of tests/test_training.py (ViT 32 wide, 2 deep, 56 x 56,
K = 4 slots) in fp32, the same synthetic body model (64 vertices, 55
joints), JAX-initialised weights carried across by ``params_from_jax``, and
the same seeded batch. Tolerances, each relative to the largest magnitude of
the compared value:

  * ``prepare_gt``: 1e-5 on every float key (fp32 body-model forward and
    projections in other summation orders); detections and masks exactly.
  * ``multihmr_loss`` on random inputs: 1e-6 on every term.
  * one Adam train step at epochs 0 and 10 against JAX ``make_train_step``:
    loss terms 1e-4; each parameter's gradient 2e-3 (fp32 backward through
    two ViT blocks, the head and the LBS body model, summed in other orders;
    the tiny random net's gradients span many magnitudes); parameters after
    the update within 1e-3 of the step size where the JAX gradient is at
    least 1e-2 of its parameter's largest (Adam's first step moves each
    parameter by lr * g / (|g| + eps), so the sign of a gradient at its
    noise floor decides a full step), and everywhere within 1e-3 of the step
    of Adam's closed form on the port's own gradients.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR
from multihmr_tpu.train import loss as jloss
from multihmr_tpu.train import trainer as jtrainer
from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.io.convert import params_from_jax
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from multihmr_tpu_torch.train import loss as tloss
from multihmr_tpu_torch.train import trainer as ttrainer
from tests.test_training import TinyConfig
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

LR = 1e-3
BM_ARGS = dict(num_vertices=64, num_joints=55, num_extra=21, num_lmk=51)
K_TINY = [[100.0, 0, 28], [0, 100, 28], [0, 0, 1]]


def _cfg(**kw):
    return TinyConfig(img_size=56, max_people=4, person_center="head",
                      compute_dtype="float32", **kw)


def _batch(seed=0, B=2, Kh=4):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(B, 56, 56, 3)).astype(np.float32),
        "K": np.broadcast_to(np.asarray(K_TINY, np.float32), (B, 3, 3)).copy(),
        "gt_pose": rng.normal(scale=0.2, size=(B, Kh, 53, 3)).astype(np.float32),
        "gt_shape": rng.normal(size=(B, Kh, 10)).astype(np.float32),
        "gt_transl": (rng.normal(scale=0.3, size=(B, Kh, 3)) + [0, 0, 4]).astype(np.float32),
        "gt_valid": np.array([[1, 1, 1, 0], [1, 0, 0, 0]], np.float32)[:B],
    }


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _port_bm():
    return BodyModel.from_arrays(synthetic_body_model(**BM_ARGS), "cpu")


def _prepare(batch, cfg):
    jbm = jsynthetic(**BM_ARGS)
    a = jax.jit(lambda *t: jtrainer.prepare_gt(jbm, *t, img_size=56, patch_size=14))(
        *(jnp.asarray(batch[k]) for k in ("gt_pose", "gt_shape", "gt_transl", "gt_valid", "K")))
    b = ttrainer.prepare_gt(_port_bm(), *(torch.from_numpy(batch[k]) for k in (
        "gt_pose", "gt_shape", "gt_transl", "gt_valid", "K")), img_size=56, patch_size=14)
    return a, b


def test_prepare_gt_matches_jax():
    a, b = _prepare(_batch(), _cfg())
    assert sorted(a) == sorted(b)
    for f in ("rows", "cols", "scores", "valid"):
        np.testing.assert_array_equal(getattr(b["det"], f).numpy(), np.asarray(getattr(a["det"], f)))
    for k in a:
        if k == "det":
            continue
        assert tuple(b[k].shape) == a[k].shape, k
        assert _rel(b[k].numpy(), a[k]) <= 1e-5, (k, _rel(b[k].numpy(), a[k]))
    assert float(b["scores"].sum()) == float(b["valid"].sum())


def test_prepare_gt_collision_drop():
    # two identical people land in one heatmap cell: the second is dropped
    z = torch.zeros
    transl = torch.tensor([[[0, 0, 4.0], [0, 0, 4.0], [1.5, 0, 4.0]]])
    K = torch.tensor([K_TINY])
    gt = ttrainer.prepare_gt(_port_bm(), z(1, 3, 53, 3), z(1, 3, 10), transl, torch.ones(1, 3),
                             K, img_size=56, patch_size=14)
    assert gt["valid"].tolist() == [[1.0, 0.0, 1.0]]
    assert gt["det"].rows.tolist()[0][1] == gt["det"].cols.tolist()[0][1] == 0
    assert float(gt["scores"].sum()) == 2.0


@pytest.mark.parametrize("epoch", [0, 10])
def test_loss_matches_jax(epoch):
    rng = np.random.default_rng(3)
    B, K, g = 2, 4, 4
    shapes = {"offset": (B, K, 2), "rotmat": (B, K, 53, 3, 3), "shape": (B, K, 10),
              "transl": (B, K, 3), "transl_pelvis": (B, K, 1, 3), "j3d": (B, K, 127, 3),
              "v3d": (B, K, 64, 3), "j2d": (B, K, 127, 2), "v2d": (B, K, 64, 2)}
    pred = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    gt = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    for d in (pred, gt):  # 2D points partly inside the 56-pixel frame
        d["j2d"] = (d["j2d"] * 30 + 28).astype(np.float32)
        d["v2d"] = (d["v2d"] * 30 + 28).astype(np.float32)
    pred["scores"] = rng.uniform(1e-4, 1 - 1e-4, size=(B, g, g, 1)).astype(np.float32)
    pred["dist_postprocessed"] = rng.normal(size=(B, K, 1)).astype(np.float32)
    gt["dist_postprocessed"] = rng.normal(size=(B, K)).astype(np.float32)
    gt["scores"] = (rng.uniform(size=(B, g, g, 1)) > 0.8).astype(np.float32)
    gt["valid"] = np.array([[1, 1, 0, 0], [1, 0, 1, 0]], np.float32)
    w = jloss.LossWeights()
    _, want = jloss.multihmr_loss({k: jnp.asarray(v) for k, v in pred.items()},
                                  {k: jnp.asarray(v) for k, v in gt.items()}, w, epoch=epoch,
                                  img_size=56)
    _, got = tloss.multihmr_loss({k: torch.from_numpy(v) for k, v in pred.items()},
                                 {k: torch.from_numpy(v) for k, v in gt.items()},
                                 tloss.LossWeights(), epoch=epoch, img_size=56)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= 1e-6, (k, _rel(got[k].numpy(), want[k]))
    # a non-finite raw term is masked to 0 and clears the flag
    pred["offset"][0, 0, 0] = np.nan
    _, bad = tloss.multihmr_loss({k: torch.from_numpy(v) for k, v in pred.items()},
                                 {k: torch.from_numpy(v) for k, v in gt.items()},
                                 tloss.LossWeights(), epoch=epoch, img_size=56)
    assert float(bad["finite"]) == 0.0 and float(bad["offset"]) == 0.0


def test_loss_weights_equal():
    assert dataclasses.asdict(tloss.LossWeights()) == dataclasses.asdict(jloss.LossWeights())


@pytest.fixture(scope="module")
def jax_step():
    """JAX params, then per epoch (0, 10) the gradients, the parameters after
    one ``make_train_step`` Adam step, and the loss terms. The gradients are
    read from Adam's first moment, mu = (1 - b1) g after one step, so one
    compiled step gives all three."""
    cfg = _cfg()
    jm = JMultiHMR(cfg, jsynthetic(**BM_ARGS))
    params = jm.init_params(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    opt = optax.adam(LR)
    step = jtrainer.make_train_step(jm, opt, jloss.LossWeights(), donate=False)
    out = {}
    for epoch in (0, 10):
        new_params, opt_state, terms = step(params, opt.init(params), batch, epoch)
        grads = jax.tree_util.tree_map(lambda m: m / 0.1, opt_state[0].mu)
        out[epoch] = jax.device_get((grads, new_params, terms))
    return cfg, jax.device_get(params), out


@pytest.mark.parametrize("epoch", [0, 10])
def test_train_step_matches_jax(jax_step, epoch):
    cfg, params, out = jax_step
    j_grads, j_new, j_terms = out[epoch]
    net = MultiHMRNet(cfg)
    net.load_state_dict(params_from_jax(params, cfg), strict=True)
    model = MultiHMR(cfg, _port_bm(), net=net.eval())
    opt = torch.optim.Adam(net.parameters(), lr=LR, eps=1e-8)
    step = ttrainer.make_train_step(model, opt)
    terms = step(ttrainer.to_device(_batch(), "cpu"), epoch)
    assert net.training  # the step puts the net in training mode
    assert sorted(terms) == sorted(j_terms)
    for k in terms:
        assert _rel(terms[k].numpy(), j_terms[k]) <= 1e-4, (k, float(terms[k]), j_terms[k])
    grads = params_from_jax(j_grads, cfg)  # the grad tree has the params' structure
    new = params_from_jax(j_new, cfg)
    before = params_from_jax(params, cfg)
    assert sorted(grads) == sorted(dict(net.named_parameters()))
    for name, p in net.named_parameters():
        assert p.grad is not None, name
        assert _rel(p.grad.numpy(), grads[name].numpy()) <= 2e-3, name
        g, gj = p.grad.numpy(), grads[name].numpy()
        after, b0 = p.detach().numpy(), before[name].numpy()
        # Adam's first step, optax's formula, on the port's own gradients
        np.testing.assert_allclose(after, b0 - LR * g / (np.abs(g) + 1e-8),
                                   rtol=0, atol=1e-3 * LR + 1e-6 * np.abs(b0).max(), err_msg=name)
        # against JAX's updated parameters where the gradient clears its
        # noise floor (a near-zero gradient's sign is noise: a full step)
        clear = np.abs(gj) >= 1e-2 * np.abs(gj).max()
        np.testing.assert_allclose(after[clear], new[name].numpy()[clear], rtol=0,
                                   atol=1e-3 * LR + 1e-6 * np.abs(b0).max(), err_msg=name)


def test_train_and_eval_mode_give_the_same_forward():
    cfg = _cfg()
    net = MultiHMRNet(cfg).init_weights(torch.Generator().manual_seed(0))
    model = MultiHMR(cfg, _port_bm(), net=net)
    b = ttrainer.to_device(_batch(), "cpu")
    with torch.no_grad():
        a = model.forward(b["image"], b["K"], det_thresh=0.0)
        net.train()
        c = model.forward(b["image"], b["K"], det_thresh=0.0)
    for k in ("scores", "loc", "dist", "v3d"):
        torch.testing.assert_close(a[k], c[k], rtol=0, atol=0)


def test_training_forward_requires_gt_det():
    cfg = _cfg()
    model = MultiHMR(cfg, _port_bm(), net=MultiHMRNet(cfg))
    b = ttrainer.to_device(_batch(), "cpu")
    with pytest.raises(ValueError, match="gt_det"):
        model.forward(b["image"], b["K"], is_training=True)
