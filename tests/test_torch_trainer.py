"""The port's Trainer on the tiny fp32 configuration, on the CPU: the cases of
tests/test_training.py for the JAX Trainer (checkpoint and prune, NaN abort,
windowed loss fetch, bitwise resume) and remat. Samples are seeded synthetic
people collated by ``data/collate.py::collate_padded``.

Tolerances: the windowed and the per-step mean loss agree to 1e-6 relative
(the same fp32 losses summed in fp64 in other groupings); a resumed run is
bitwise equal to an uninterrupted one; remat "mlp" and "block" give the
gradients of no remat to 1e-6 of each parameter's largest (the recomputed
activations are the same, the sums may run in another order).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.config import ModelConfig, ViTConfig
from multihmr_tpu_torch.data.collate import collate_padded
from multihmr_tpu_torch.io.checkpoint import load_checkpoint
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from multihmr_tpu_torch.train.trainer import Trainer, make_train_step, to_device

CFG = ModelConfig(img_size=56, max_people=4, compute_dtype="float32",
                  vit_override=ViTConfig(embed_dim=32, depth=2, num_heads=2))


def make_model(cfg=CFG, seed=0):
    bm = BodyModel.from_arrays(synthetic_body_model(num_vertices=64, num_joints=55,
                                                    num_extra=21, num_lmk=51), "cpu")
    net = MultiHMRNet(cfg).init_weights(torch.Generator().manual_seed(seed))
    return MultiHMR(cfg, bm, net=net)


def make_batches(n, seed=7, B=1):
    """``n`` collated batches of seeded synthetic people (2 per image)."""
    rng = np.random.default_rng(seed)
    K = np.array([[100.0, 0, 28], [0, 100, 28], [0, 0, 1]], np.float32)
    out = []
    for _ in range(n):
        samples = [{"image": rng.normal(size=(56, 56, 3)).astype(np.float32), "K": K,
                    "humans": [{"pose": rng.normal(scale=0.2, size=(53, 3)).astype(np.float32),
                                "shape": rng.normal(size=(10,)).astype(np.float32),
                                "transl": (rng.normal(scale=0.3, size=3) + [0, 0, 4]).astype(
                                    np.float32)} for _ in range(2)]} for _ in range(B)]
        out.append(collate_padded(samples, CFG.max_people))
    return out


def test_fit_checkpoints_and_prunes(tmp_path):
    model = make_model()
    batches = make_batches(2)
    lines, evals = [], []
    trainer = Trainer(model, torch.optim.Adam(model.net.parameters(), 1e-4),
                      checkpoint_dir=str(tmp_path), nb_max_ckpt=2, log_fn=lines.append,
                      log_every_steps=1, sync_every=1)
    trainer.fit(lambda: iter(batches), epochs=3, eval_fn=lambda m, e: evals.append(e))
    files = sorted(os.listdir(tmp_path))
    assert files == ["ckpt_000001.json", "ckpt_000001.pt", "ckpt_000002.json",
                     "ckpt_000002.pt", "state"]
    assert sorted(os.listdir(tmp_path / "state")) == ["state_000001.pt", "state_000002.pt"]
    assert evals == [0, 1, 2]
    assert sum("epoch 0 [" in ln for ln in lines) == 2  # one progress line per step
    summaries = [ln for ln in lines if "mean loss" in ln]
    assert len(summaries) == 3 and all("ratio_data" in ln for ln in summaries)
    sd, meta = load_checkpoint(str(tmp_path / "ckpt_000002.pt"))
    assert meta["epoch"] == 2 and meta["config"] == dataclasses.asdict(CFG)
    for k, v in model.net.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_fit_aborts_on_sustained_nan():
    model = make_model()
    lines = []
    trainer = Trainer(model, torch.optim.SGD(model.net.parameters(), lr=1e12),
                      log_fn=lines.append, sync_every=2, nan_abort_steps=4)
    with pytest.raises(RuntimeError, match="non-finite"):
        trainer.fit(lambda: iter(make_batches(30)), epochs=1)
    assert any("WARNING" in ln for ln in lines)


def _mean_loss(lines, epoch=0):
    for ln in lines:
        m = re.match(rf"epoch {epoch}: mean loss ([0-9.eE+-]+)", ln)
        if m:
            return m.group(1)
    raise AssertionError(lines)


def test_sync_window_matches_per_step():
    batches = make_batches(5)

    def mean_loss(sync_every):
        model = make_model()
        lines = []
        Trainer(model, torch.optim.Adam(model.net.parameters(), 1e-4), log_fn=lines.append,
                sync_every=sync_every).fit(lambda: iter(batches), epochs=1)
        return float(_mean_loss(lines))

    per_step, windowed = mean_loss(1), mean_loss(3)  # windows of 3 and 2
    assert np.isclose(per_step, windowed, rtol=1e-6, atol=0), (per_step, windowed)


def test_resume_is_bitwise_identical(tmp_path):
    batches = make_batches(2)

    def trainer(model, d, lines):
        return Trainer(model, torch.optim.Adam(model.net.parameters(), 1e-3),
                       checkpoint_dir=str(d), nb_max_ckpt=5, log_fn=lines.append)

    lines_a, lines_b = [], []
    model_a = make_model()
    trainer(model_a, tmp_path / "a", lines_a).fit(lambda: iter(batches), epochs=4)

    trainer(make_model(), tmp_path / "b", lines_b).fit(lambda: iter(batches), epochs=2)
    model_b = make_model(seed=1)  # a new process: other weights until restored
    t2 = trainer(model_b, tmp_path / "b", lines_b)
    start = t2.restore()
    assert start == 2
    t2.fit(lambda: iter(batches), epochs=4, start_epoch=start)

    for (k, a), b in zip(model_a.net.state_dict().items(), model_b.net.state_dict().values()):
        assert torch.equal(a, b), k
    for e in range(4):
        assert _mean_loss(lines_a, e) == _mean_loss(lines_b, e)
    assert trainer(make_model(), tmp_path / "c", []).restore() is None


@pytest.mark.parametrize("policy", ["mlp", "block"])
def test_remat_gives_the_same_gradients(policy):
    batch = to_device(make_batches(1, B=2)[0], "cpu")

    def grads(cfg):
        model = make_model(cfg)
        make_train_step(model, torch.optim.SGD(model.net.parameters(), lr=0.0))(batch, 0)
        return {k: p.grad.clone() for k, p in model.net.named_parameters()}

    want = grads(CFG)
    got = grads(dataclasses.replace(CFG, remat=True, remat_policy=policy))
    for k, g in want.items():
        assert (got[k] - g).abs().max() <= 1e-6 * g.abs().max(), k


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        MultiHMRNet(dataclasses.replace(CFG, remat=True, remat_policy="attn"))


def test_train_smoke_tool_on_cpu(monkeypatch, capsys):
    import multihmr_tpu_torch.factory as factory
    from multihmr_tpu_torch.tools import train_smoke

    # the tool's batch has a 900-pixel focal, so keep its 896-pixel image (a
    # 56-pixel image would scale the regressed log-depth 18-fold and overflow
    # exp); 56-pixel patches keep the ViT at 257 tokens
    cfg = ModelConfig(img_size=896, compute_dtype="float32",
                      vit_override=ViTConfig(embed_dim=32, depth=2, num_heads=2, patch_size=56))
    monkeypatch.setattr(train_smoke, "named_config", lambda name: cfg)
    small = synthetic_body_model(num_joints=55, num_vertices=64, num_extra=21, num_lmk=51)
    monkeypatch.setattr(factory, "smplx_like_synthetic", lambda nb: small)
    assert train_smoke.main(["--model", "multiHMR_672_S", "--batch", "2", "--steps", "3",
                             "--remat_policy", "block", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "remat=block" in out and out.count("loss=") == 3 and "median step" in out
    assert "host clock" in out
    assert out.rstrip().endswith("train smoke OK")


def test_clip_grad_bounds_the_global_norm():
    batch = to_device(make_batches(1)[0], "cpu")
    model = make_model()
    make_train_step(model, torch.optim.SGD(model.net.parameters(), lr=0.0), clip_grad=0.5)(batch, 0)
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in model.net.parameters() if p.grad is not None]))
    assert float(norm) <= 0.5 * (1 + 1e-5)
