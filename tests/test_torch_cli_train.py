"""The port's training CLI (``multihmr_tpu_torch/cli/train.py::main``) end to
end on the CPU, on the synthetic BEDLAM and EHF trees of
tests/test_cli_train.py: one epoch of BEDLAM training on each ViT stream
with the epoch-end BEDLAM + EHF evaluation, ``--eval_only 1 --amp 0``,
``--resume`` and ``--pretrained`` (this port's checkpoints and the JAX
package's ``.msgpack`` here; reference
``multiHMR_*.pt`` files in tests/test_torch_checkpoint.py, whose faults must
raise the JAX package's errors), the mesh flags' checks, which must raise,
and ``--visu_to_save``'s eval triptychs. ``--valset
3dpw`` is in tests/test_torch_threedpw.py."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from multihmr_tpu_torch.cli.train import main
from tests.test_cli_train import _write_bedlam, _write_ehf
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

TINY = ["--backbone", "dinov2_vits14", "--img_size", "56", "--xat_depth", "1",
        "--max_people", "4", "--n_devices", "1", "--device", "cpu"]
TRAIN = ["--batch_size", "2", "--iter_per_epoch", "2", "--lr", "1e-5"]


@pytest.fixture(scope="module")
def written_trees(tmp_path_factory):
    """The synthetic BEDLAM and EHF trees, written once a module; no case
    runs in them."""
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(0)
    _write_bedlam(root / "data" / "BEDLAM", rng)
    _write_bedlam(root / "data" / "BEDLAM", rng, split="validation")
    _write_ehf(root / "data" / "EHF", rng)
    return root


@pytest.fixture
def trees(written_trees, tmp_path, monkeypatch):
    """A case's own copy of the trees, as its working directory."""
    shutil.copytree(written_trees / "data", tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _metrics(name):
    with open(os.path.join("logs", name, "metrics.jsonl")) as f:
        return {r["tag"]: r["value"] for r in map(json.loads, f)}


# one BEDLAM epoch with the epoch-end BEDLAM + EHF evaluation; with
# ``--resume 1`` and no saved state it trains from scratch
EPOCH = TRAIN + ["--valset", "bedlam", "ehf", "--val_n", "2", "1", "--resume", "1"]


def _epoch(tp_mode, name):
    """``main`` of one EPOCH on ``tp_mode`` in the working directory: its
    stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(TINY + EPOCH + ["--n_epoch", "1", "--tp_mode", tp_mode, "--name", name])
    return out.getvalue()


@pytest.fixture(scope="module")
def heads_epoch(written_trees, tmp_path_factory):
    """One EPOCH on the channels-major stream, run once a module in its own
    copy of the trees: (that directory, stdout). Read by
    test_train_cli_end_to_end[heads]; test_train_cli_resume_and_pretrained
    continues from a copy of it."""
    root = tmp_path_factory.mktemp("heads_epoch")
    shutil.copytree(written_trees / "data", root / "data")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        return root, _epoch("heads", "itest")


@pytest.mark.parametrize("tp_mode", ["ring", "heads"])
def test_train_cli_end_to_end(request, monkeypatch, tp_mode):
    if tp_mode == "heads":
        root, out = request.getfixturevalue("heads_epoch")
        monkeypatch.chdir(root)  # read only
    else:
        request.getfixturevalue("trees")
        out = _epoch(tp_mode, "itest")
    assert "remat auto" in out and "no remat" in out
    loss = out.split("epoch 0: mean loss")[1].split()[0]
    assert np.isfinite(float(loss))
    assert "eval[bedlam-validation] epoch 0" in out and "eval[ehf-test] epoch 0" in out
    assert "'n_images': 1" in out.split("eval[ehf-test]")[1][:400]
    names = os.listdir(os.path.join("ckpts", "itest"))
    assert "ckpt_000000.pt" in names and "ckpt_000000.json" in names and "state" in names
    m = _metrics("itest")
    assert m["bedlam-validation-1/n_images"] == 2 and m["ehf-test-1/n_images"] == 1
    assert all(np.isfinite(v) for v in m.values())


def test_train_cli_eval_only_fp32(trees, capsys):
    main(TINY + ["--valset", "ehf", "--eval_only", "1", "--amp", "0", "--tp_mode", "ring",
                 "--name", "itest-eval"])
    out = capsys.readouterr().out
    assert "eval[ehf-test] epoch 0" in out and "pve" in out
    assert not os.path.exists("ckpts")  # evaluation only: no training, no checkpoint


def test_train_cli_resume_and_pretrained(heads_epoch, tmp_path, monkeypatch, capsys):
    """The first epoch is heads_epoch's (``--resume 1`` with no saved state);
    the same command line with one more epoch continues in a copy of it."""
    root, out = heads_epoch
    assert "no saved train state found" in out and "epoch 0: mean loss" in out
    shutil.copytree(root, tmp_path, dirs_exist_ok=True)
    monkeypatch.chdir(tmp_path)
    main(TINY + EPOCH + ["--n_epoch", "2", "--tp_mode", "heads", "--name", "itest"])
    out = capsys.readouterr().out
    assert "restored epoch 0, continuing at epoch 1" in out
    assert "epoch 1: mean loss" in out and "epoch 0: mean loss" not in out
    state = torch.load(os.path.join("ckpts", "itest", "state", "state_000001.pt"),
                       weights_only=True)
    assert state["epoch"] == 1
    # the checkpoint of epoch 1 loads as --pretrained and evaluates
    main(TINY + ["--valset", "ehf", "--eval_only", "1", "--name", "pre",
                 "--pretrained", os.path.join("ckpts", "itest", "ckpt_000001.pt")])
    assert "eval[ehf-test] epoch 0" in capsys.readouterr().out


def test_train_cli_visu_to_save(trees, capsys):
    """--visu_to_save writes an [input | prediction | GT] triptych per valset
    for the first images, as the JAX CLI does (tests/test_cli_train.py)."""
    from PIL import Image

    main(TINY + ["--valset", "bedlam", "ehf", "--val_n", "2", "1", "--eval_only", "1",
                 "--visu_to_save", "1", "--name", "visu"])
    out = capsys.readouterr().out
    assert "eval[bedlam-validation] epoch 0" in out and "eval[ehf-test] epoch 0" in out
    for vname in ("bedlam", "ehf"):
        d = os.path.join("logs", "visu", f"visu_{vname}")
        assert sorted(os.listdir(d)) == ["eval_0000.png"]  # the first image only
        strip = np.asarray(Image.open(os.path.join(d, "eval_0000.png")))
        assert strip.shape == (56, 3 * 56, 3)


@pytest.mark.parametrize("flags,match", [
    (["--n_devices", "2"], "torchrun --nproc_per_node 2"),
    (["--model_parallel", "2"], "not divisible by --model_parallel"),
    (["--n_devices", "2", "--batch_size", "3"], "must divide over the data axis"),
])
def test_unported_flags_raise(trees, flags, match):
    """What the JAX CLI asserts of the mesh flags, and a multi-device run
    without its launcher, raise before any work."""
    with pytest.raises(ValueError, match=match):
        main(TINY[:-4] + ["--device", "cpu"] + flags)


def test_train_cli_mesh_resumes_on_one_device(trees, capsys):
    """``--n_devices 2 --model_parallel 2 --fsdp 1`` on two spawned gloo
    ranks (as torchrun would start them): the JAX CLI's mesh line, two TP
    steps, rank 0's checkpoint and evaluation; then the same run resumed on
    one device from that checkpoint."""
    from multihmr_tpu_torch.parallel.launch import run_ranks
    from tests import torch_parallel_ranks

    mesh_flags = ["--n_devices", "2", "--model_parallel", "2", "--fsdp", "1"]
    run = TRAIN + ["--valset", "ehf", "--val_n", "1", "--name", "mesh"]
    run_ranks(torch_parallel_ranks.cli_world, 2,
              (os.getcwd(), TINY[:-4] + ["--device", "cpu"] + mesh_flags + run + ["--n_epoch", "1"]))
    names = os.listdir(os.path.join("ckpts", "mesh"))
    assert "ckpt_000000.pt" in names and "state" in names
    m = _metrics("mesh")
    assert m["ehf-test-1/n_images"] == 1 and all(np.isfinite(v) for v in m.values())
    with open(os.path.join("ckpts", "mesh", "ckpt_000000.json")) as f:
        assert json.load(f)["epoch"] == 0

    main(TINY + run + ["--n_epoch", "2", "--resume", "1"])
    out = capsys.readouterr().out
    assert "--resume: restored epoch 0, continuing at epoch 1" in out
    assert np.isfinite(float(out.split("epoch 1: mean loss")[1].split()[0]))
    assert "ckpt_000001.pt" in os.listdir(os.path.join("ckpts", "mesh"))


def _jax_checkpoint(ckpt_dir):
    """The JAX package's save_checkpoint of a model at TINY's configuration
    (the JAX CLI's config for those flags), and the same params as this
    port's own checkpoint (params_from_jax, save_checkpoint)."""
    import jax

    from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
    from multihmr_tpu.config import ModelConfig as JConfig
    from multihmr_tpu.io.checkpoint import save_checkpoint as jsave
    from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR
    from multihmr_tpu_torch.config import ModelConfig
    from multihmr_tpu_torch.io.checkpoint import save_checkpoint
    from multihmr_tpu_torch.io.convert import params_from_jax

    kw = dict(backbone="dinov2_vits14", img_size=56, xat_depth=1, max_people=4)
    params = JMultiHMR(JConfig(**kw), jsynthetic()).init_params(jax.random.PRNGKey(1))
    msgpack_path = jsave(os.path.join(ckpt_dir, "jax"), params, 0, JConfig(**kw))
    cfg = ModelConfig(**kw)
    pt_path = save_checkpoint(os.path.join(ckpt_dir, "port"),
                              params_from_jax(jax.device_get(params), cfg), 0, cfg)
    return msgpack_path, pt_path


def test_pretrained_jax_msgpack_matches_port_checkpoint(trees, capsys):
    """--pretrained of the JAX package's ckpt_*.msgpack evaluates exactly as
    the same weights in this port's own ckpt_*.pt (ROADMAP Queue 1, M5)."""
    msgpack_path, pt_path = _jax_checkpoint("given")
    for name, path in (("from_msgpack", msgpack_path), ("from_pt", pt_path)):
        main(TINY + ["--valset", "ehf", "--eval_only", "1", "--amp", "0", "--name", name,
                     "--pretrained", path])
        assert "eval[ehf-test] epoch 0" in capsys.readouterr().out
    got, want = _metrics("from_msgpack"), _metrics("from_pt")
    assert got == want and "ehf-test-1/pve" in got and np.isfinite(got["ehf-test-1/pve"])


@pytest.mark.parametrize("content,error,match", [
    (b"\x80", KeyError, "port keys not filled"),  # an empty map: no parameter at all
    (b"\x81\xa6params\xc7", ValueError, "truncated"),
])
def test_corrupt_msgpack_raises_before_any_work(trees, content, error, match):
    # a flax .msgpack that does not decode or map is refused before the
    # model is built or a log is opened
    with open("ckpt.msgpack", "wb") as f:
        f.write(content)
    with pytest.raises(error, match=match):
        main(TINY + ["--pretrained", "ckpt.msgpack", "--eval_only", "1"])
    assert not os.path.exists("logs")


def _reference_file(path, fault):
    """A reference-layout checkpoint for TINY's configuration, with a fault."""
    from multihmr_tpu_torch.config import ModelConfig
    from multihmr_tpu_torch.io.checkpoint import expected_reference_shapes

    cfg = ModelConfig(backbone="dinov2_vits14", img_size=56, xat_depth=1, max_people=4)
    sd = {k: torch.zeros([s or 5 for s in shape])
          for k, shape in expected_reference_shapes(cfg).items()}
    if fault == "missing":
        del sd["x_attention_head.deccam.bias"]
    elif fault == "bad_shape":
        sd["backbone.encoder.patch_embed.proj.weight"] = torch.zeros(384, 14, 14, 3)
    torch.save({"model_state_dict": sd}, path)


@pytest.mark.parametrize("fault,error,match", [
    ("missing", KeyError, "missing 1 expected keys"),
    ("bad_shape", ValueError, "shapes the converter's transposes/reshapes cannot accept"),
    ("absent", FileNotFoundError, "multiHMR_896_L.pt"),
])
def test_reference_pretrained_faults_raise(trees, fault, error, match):
    """A reference ``--pretrained`` (no .json beside it) goes through the
    converter, whose faults raise as the JAX package's do, before any eval."""
    if fault != "absent":
        _reference_file("multiHMR_896_L.pt", fault)
    with pytest.raises(error, match=match):
        main(TINY + ["--pretrained", "multiHMR_896_L.pt", "--eval_only", "1"])
    assert not os.path.exists(os.path.join("logs", "run"))


def test_mean_params_applied_when_present(tmp_path):
    """From-scratch training starts from smpl_mean_params.npz when it exists
    (the JAX CLI's apply_mean_params); without it HPH keeps its init."""
    from multihmr_tpu_torch.cli.train import _apply_mean_params
    from multihmr_tpu_torch.config import ModelConfig
    from multihmr_tpu_torch.models.multihmr import MultiHMRNet

    cfg = ModelConfig(backbone="dinov2_vits14", img_size=56, xat_depth=1)
    net = MultiHMRNet(cfg)
    before = net.x_attention_head.init_cam.detach().clone()
    _apply_mean_params(net, cfg, str(tmp_path))  # no asset: unchanged
    assert torch.equal(net.x_attention_head.init_cam, before)
    rng = np.random.default_rng(0)
    mean = {"pose": rng.normal(size=(144,)), "shape": rng.normal(size=(10,)),
            "cam": np.array([0.7, 0.1, -0.1])}
    np.savez(tmp_path / "smpl_mean_params.npz", **mean)
    _apply_mean_params(net, cfg, str(tmp_path))
    head = net.x_attention_head
    np.testing.assert_allclose(head.init_cam.detach().numpy()[0], mean["cam"], rtol=1e-6)
    np.testing.assert_allclose(head.init_betas.detach().numpy()[0], mean["shape"], rtol=1e-6)
    np.testing.assert_allclose(head.init_body_pose.detach().numpy()[0, :144], mean["pose"],
                               rtol=1e-6)
