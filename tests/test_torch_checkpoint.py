"""The reference-checkpoint loader of the port against the JAX package's.

``io/checkpoint.py::convert_reference_checkpoint`` must give, for each of the
six named SMPL-X configurations cut to a tiny ViT (32 wide, 2 or 4 blocks),
tensors **equal** (max |diff| = 0) to the JAX package's
``convert_torch_checkpoint`` followed by ``params_from_jax``, with the same
key set; its errors and warnings must carry the JAX text. The copied numpy
modules (``ops/posenc.py``, ``bodymodel/manifest.py``) must give what the
originals give.

Then the whole slice through a file, in fp32 on a tiny configuration (ViT-S
width, 56 x 56, 4 slots), with ``make_reference_state_dict``'s weights
scaled by fan_in^-0.5 (the "tempered" weights of tests/test_torch_model.py,
activations O(1); ``tempered_state_dict``):
  * ``cli/demo.py --ckpt``: each person's ``v3d`` within 1e-4 of the largest
    magnitude of the JAX package's (``TOLS["tempered"]["v3d"]`` of
    tests/test_torch_model.py), detections equal;
  * ``cli/train.py --pretrained x.pt --eval_only 1`` on an EHF tree whose GT
    meshes are the JAX model's own predictions with those weights: the
    metrics of the JAX CLI, precision/recall/F1 equal, PVE within 1e-3
    relative and PA-PVE within 1e-2 mm (as tests/test_torch_evaluate.py).
"""

import argparse
import dataclasses
import json
import os
import sys
import warnings

import numpy as np
import pytest
import jax
import torch

from multihmr_tpu import config as jconfig
from multihmr_tpu.bodymodel import manifest as jmanifest
from multihmr_tpu.io import checkpoint as jckpt
from multihmr_tpu.ops import posenc as jposenc
from multihmr_tpu_torch import config as tconfig
from multihmr_tpu_torch.bodymodel import manifest as tmanifest
from multihmr_tpu_torch.io import checkpoint as tckpt
from multihmr_tpu_torch.io.convert import params_from_jax
from multihmr_tpu_torch.ops import posenc as tposenc
from tests.test_checkpoint import make_reference_state_dict
from tests.test_torch_model import TOLS
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

NAMES = ("multiHMR_896_L", "multiHMR_672_L", "multiHMR_672_B", "multiHMR_672_S",
         "multiHMR_1288_L_bedlam", "multiHMR_1288_L_agora")


def _tiny(cfg_mod, name, depth=2, **kw):
    base = cfg_mod.named_config(name)
    vit = cfg_mod.ViTConfig(embed_dim=32, depth=depth, num_heads=2)
    return dataclasses.replace(base, vit_override=vit, **kw)


def _jax_port_sd(ckpt, jcfg, tcfg):
    """The JAX converter's tree through params_from_jax: the reference."""
    return params_from_jax(jax.device_get(jckpt.convert_torch_checkpoint(ckpt, jcfg)), tcfg)


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), (k, (got[k] - want[k]).abs().max().item())


@pytest.mark.parametrize("name,depth", [(n, 4 if i % 2 else 2) for i, n in enumerate(NAMES)])
def test_convert_bitwise_equal(name, depth):
    jcfg, tcfg = _tiny(jconfig, name, depth), _tiny(tconfig, name, depth)
    sd = make_reference_state_dict(jcfg, np.random.default_rng(depth))
    got = tckpt.convert_reference_checkpoint(sd, tcfg)  # a bare state dict
    _assert_equal(got, _jax_port_sd(sd, jcfg, tcfg))
    with torch.device("meta"):
        from multihmr_tpu_torch.models.multihmr import MultiHMRNet

        assert sorted(got) == sorted(MultiHMRNet(tcfg).state_dict())


def test_convert_torch_saved_file(tmp_path):
    """A ``torch.save`` file with ``args`` as an argparse namespace (why the
    loader needs ``weights_only=False``), from its path."""
    jcfg, tcfg = _tiny(jconfig, "multiHMR_896_L"), _tiny(tconfig, "multiHMR_896_L")
    sd = make_reference_state_dict(jcfg, np.random.default_rng(5))
    path = str(tmp_path / "multiHMR_896_L.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": argparse.Namespace(backbone="dinov2_vitl14", img_size=[896])}, path)
    _assert_equal(tckpt.convert_reference_checkpoint(path, tcfg),
                  _jax_port_sd(path, jcfg, tcfg))


def test_convert_bf16_file_loads_as_fp32(tmp_path):
    """The port casts every tensor to fp32, whatever the file stores (the
    JAX converter's ``.numpy()`` cannot take bf16): its result equals the JAX
    conversion of the same values stored in fp32."""
    jcfg, tcfg = _tiny(jconfig, "multiHMR_672_S"), _tiny(tconfig, "multiHMR_672_S")
    sd = make_reference_state_dict(jcfg, np.random.default_rng(6))
    bf16 = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
    path = str(tmp_path / "bf16.pt")
    torch.save({"model_state_dict": bf16}, path)
    as_fp32 = {k: v.float().numpy() for k, v in bf16.items()}
    _assert_equal(tckpt.convert_reference_checkpoint(path, tcfg),
                  _jax_port_sd({"model_state_dict": as_fp32}, jcfg, tcfg))


def _raised(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return info


@pytest.mark.parametrize("fault", ["missing", "bad_shape"])
def test_convert_errors_carry_the_jax_text(fault):
    jcfg, tcfg = _tiny(jconfig, "multiHMR_896_L"), _tiny(tconfig, "multiHMR_896_L")
    sd = make_reference_state_dict(jcfg, np.random.default_rng(7))
    if fault == "missing":
        for k in ("mlp_offset.0.weight", "backbone.encoder.blocks.1.ls2.gamma"):
            del sd[k]
    else:
        sd["backbone.encoder.patch_embed.proj.weight"] = np.zeros((32, 14, 14, 3), np.float32)
    a = _raised(jckpt.convert_torch_checkpoint, sd, jcfg)
    b = _raised(tckpt.convert_reference_checkpoint, sd, tcfg)
    assert b.type is a.type is {"missing": KeyError, "bad_shape": ValueError}[fault]
    assert str(b.value) == str(a.value)
    assert ("mlp_offset.0.weight" in str(b.value) if fault == "missing"
            else "patch_embed.proj.weight: got (32, 14, 14, 3)" in str(b.value))


def test_convert_unexpected_warns_and_ignorable_do_not():
    jcfg, tcfg = _tiny(jconfig, "multiHMR_896_L"), _tiny(tconfig, "multiHMR_896_L")
    sd = make_reference_state_dict(jcfg, np.random.default_rng(8))  # has smpl_layer.*
    sd["x_attention_head.init_betas_kid"] = np.zeros((1, 11), np.float32)
    sd["backbone.encoder.mask_token"] = np.zeros((1, 32), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the ignorable keys warn nowhere
        tckpt.convert_reference_checkpoint(sd, tcfg)
    sd["stray.weight"] = np.zeros(3, np.float32)
    with pytest.warns(UserWarning) as got:
        tckpt.convert_reference_checkpoint(sd, tcfg)
    with pytest.warns(UserWarning) as want:
        jckpt.convert_torch_checkpoint(sd, jcfg)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert "1 unexpected checkpoint keys ignored" in str(got[0].message)
    report = tckpt.validate_reference_state_dict(sd, tcfg)
    assert report == jckpt.validate_reference_state_dict(sd, jcfg)
    assert report["ignored"] == ["backbone.encoder.mask_token",
                                 "smpl_layer.neutral_10.bm_x.v_template",
                                 "x_attention_head.init_betas_kid"]


@pytest.mark.parametrize("args", [
    {"backbone": "dinov2_vitl14", "img_size": 672, "xat_depth": 2, "num_betas": 10},
    {"backbone": "dinov2_vits14", "img_size": [896, 896], "nearness": 0, "clip_dist": 0,
     "camera_embedding_num_bands": 8, "person_center": "pelvis", "num_betas": 11},
    {},
])
@pytest.mark.parametrize("as_namespace", [False, True])
def test_config_from_ckpt_args_equal(args, as_namespace):
    a = argparse.Namespace(**args) if as_namespace else args
    got = tckpt.config_from_ckpt_args(a, max_people=8)
    want = jckpt.config_from_ckpt_args(a, max_people=8)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", NAMES)
def test_expected_keys_and_shapes_equal(name):
    jcfg, tcfg = jconfig.named_config(name), tconfig.named_config(name)
    assert tckpt.expected_reference_keys(tcfg) == jckpt.expected_reference_keys(jcfg)
    assert tckpt.expected_reference_shapes(tcfg) == jckpt.expected_reference_shapes(jcfg)
    assert tckpt.expected_reference_keys_anny(tcfg) == jckpt.expected_reference_keys_anny(jcfg)


def test_posenc_copy_equal():
    rng = np.random.default_rng(9)
    pe = rng.normal(size=(1, 1 + 37 * 37, 16)).astype(np.float32)
    for g in (37, 48, 64, 92, 4):  # identity, then the 672 / 896 / 1288 grids
        np.testing.assert_array_equal(tposenc.interpolate_dinov2_pos_embed(pe, g),
                                      jposenc.interpolate_dinov2_pos_embed(pe, g))
    x = rng.normal(size=(2, 3, 9, 7))
    np.testing.assert_array_equal(tposenc.bicubic_resize_2d(x, 13, 5, 1.5, 0.7),
                                  jposenc.bicubic_resize_2d(x, 13, 5, 1.5, 0.7))
    np.testing.assert_array_equal(tposenc.get_2d_sincos_pos_embed(16, 5, n_cls_token=1),
                                  jposenc.get_2d_sincos_pos_embed(16, 5, n_cls_token=1))
    # and torch-exact: DINOv2's scale-factor resample, as F.interpolate does it
    s = (64 + 0.1) / 37
    want = torch.nn.functional.interpolate(
        torch.from_numpy(x[:, :, :8, :8].copy()), scale_factor=(s, s), mode="bicubic",
        align_corners=False).numpy()
    got = tposenc.bicubic_resize_2d(x[:, :, :8, :8], want.shape[-2], want.shape[-1], s, s)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_manifest_copy_equal(tmp_path):
    """The copied manifest reports what the JAX one reports: on an empty
    directory, and on one with a good checkpoint, a bad one and assets of
    the wrong shapes."""
    assert tmanifest.check_assets_dir(str(tmp_path)) == jmanifest.check_assets_dir(str(tmp_path))
    cfg = jconfig.named_config("multiHMR_672_S")
    args = argparse.Namespace(backbone="dinov2_vits14", img_size=[672])
    sd = {k: torch.zeros([s or 5 for s in shape])
          for k, shape in jckpt.expected_reference_shapes(cfg).items()}
    torch.save({"model_state_dict": sd, "args": args}, tmp_path / "multiHMR_672_S.pt")
    bad = dict(sd, **{"mlp_offset.2.weight": torch.zeros(3, 384)})
    del bad["backbone.encoder.norm.bias"]
    torch.save({"model_state_dict": bad, "args": args}, tmp_path / "multiHMR_bad.pt")
    np.save(tmp_path / "J_regressor_h36m.npy", np.zeros((17, 100), np.float32))
    np.savez(tmp_path / "smpl_mean_params.npz", pose=np.zeros(144), shape=np.zeros(10),
             cam=np.zeros(3))
    got = tmanifest.check_assets_dir(str(tmp_path))
    assert got == jmanifest.check_assets_dir(str(tmp_path))
    assert got["found"]["multiHMR_672_S.pt"] == 0 and got["found"]["multiHMR_bad.pt"] == 2
    for name in ("multiHMR_672_S.pt", "multiHMR_bad.pt"):
        ckpt = torch.load(tmp_path / name, weights_only=False)
        assert (tmanifest.check_checkpoint_dict(ckpt, name)
                == jmanifest.check_checkpoint_dict(ckpt, name))


# ---- the whole slice through a reference-layout file ----

VITS = ["--backbone", "dinov2_vits14", "--img_size", "56", "--xat_depth", "1",
        "--max_people", "4", "--n_devices", "1"]


def _slice_cfgs():
    kw = dict(backbone="dinov2_vits14", img_size=56, xat_depth=1, max_people=4,
              compute_dtype="float32")
    return jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)


def tempered_state_dict(cfg, seed=0):
    """``make_reference_state_dict``'s weights scaled by fan_in^-0.5, with
    LayerScale 0.5 so the blocks move the stream, and every person placed
    5 m away (exp(1.5 f / f_n)): the synthetic bodies' metres of extent stay
    in front of the camera, so their 2D joints are sane."""
    sd = make_reference_state_dict(cfg, np.random.default_rng(seed))
    for k, v in sd.items():
        if k.endswith("weight") and v.ndim >= 2:
            sd[k] = (v / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
    for k in [k for k in sd if k.endswith("gamma")]:
        sd[k] = np.full_like(sd[k], 0.5)
    sd["x_attention_head.deccam.weight"][0] = 0.0
    sd["x_attention_head.deccam.bias"][0] = 0.0
    sd["x_attention_head.init_cam"][0, 0] = 1.5
    return sd


def _tempered_file(path, cfg, seed=0):
    sd = tempered_state_dict(cfg, seed)
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": argparse.Namespace(backbone=cfg.backbone, img_size=[cfg.img_size])},
               path)


def _small_bodies(monkeypatch):
    """Both factories' no-asset body model cut to 64 vertices (SMPL-X's
    joint layout kept)."""
    import multihmr_tpu.factory as jfactory
    import multihmr_tpu_torch.factory as tfactory
    from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
    from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model

    kw = dict(num_joints=55, num_vertices=64, num_extra=21, num_lmk=51)
    monkeypatch.setattr(jfactory, "smplx_like_synthetic", lambda nb: jsynthetic(**kw))
    monkeypatch.setattr(tfactory, "smplx_like_synthetic", lambda nb: synthetic_body_model(**kw))


def test_demo_ckpt_matches_jax(tmp_path, monkeypatch):
    from PIL import Image

    import multihmr_tpu_torch.factory as tfactory
    from multihmr_tpu.factory import build_model as jbuild
    from multihmr_tpu.utils.precision import cast_backbone_bf16
    from multihmr_tpu_torch.cli import demo
    from multihmr_tpu_torch.io.preprocessing import preprocess_array

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SMPLX_DIR", raising=False)
    _small_bodies(monkeypatch)
    jcfg, tcfg = _slice_cfgs()
    monkeypatch.setattr(tfactory, "named_config", lambda name: tcfg)
    _tempered_file("x.pt", jcfg)
    os.mkdir("in")
    img = np.random.default_rng(1).integers(0, 256, size=(40, 48, 3), dtype=np.uint8)
    Image.fromarray(img).save("in/im0.png")
    demo.main(["--img_folder", "in", "--out_folder", "out", "--model_name", "multiHMR_672_S",
               "--ckpt", "x.pt", "--device", "cpu", "--det_thresh", "0.0", "--save_mesh", "1"])
    got = np.load("out/im0.png_multiHMR_672_S.png.npy")
    rec = json.loads(open("out/im0.png_multiHMR_672_S.json").read())

    jm, params = jbuild("multiHMR_672_S", cfg=jcfg, checkpoint="x.pt")
    pre = preprocess_array(img, 56)
    out = jm.forward(cast_backbone_bf16(params), pre.x[None], pre.K[None], det_thresh=0.0)
    want = jm.extract_persons(out)[0]
    assert got.shape == (len(want), 64, 3) and len(rec["persons"]) == len(want) == 4
    scale = max(np.abs(p["v3d"]).max() for p in want)
    for p_got, p_want, r in zip(got, want, rec["persons"]):
        assert np.abs(p_got - p_want["v3d"]).max() <= TOLS["tempered"]["v3d"] * scale
        loc = np.asarray(p_want["loc"])
        assert np.abs(np.asarray(r["loc"]) - loc).max() <= TOLS["tempered"]["loc"] * 56
    # a file whose keys do not fit the configuration raises the JAX KeyError
    torch.save({"model_state_dict": {}}, "empty.pt")
    with pytest.raises(KeyError, match="checkpoint is missing"):
        demo.main(["--img_folder", "in", "--ckpt", "empty.pt", "--device", "cpu",
                   "--model_name", "multiHMR_672_S"])


def _self_consistent_ehf(jm, params):
    """An EHF tree at the real 1600 x 1200 (so that K's focal suits the
    56-pixel image) whose GT meshes are the JAX model's own first persons."""
    from PIL import Image

    from multihmr_tpu.data.ehf import EHF, EHF_CAM_ROTVEC, EHF_CAM_T, _rotvec_to_rotmat_np
    from tests.test_datasets import write_ply_binary

    rng = np.random.default_rng(3)
    root = os.path.join("data", "EHF")
    os.makedirs(root)
    for i in range(2):
        write_ply_binary(os.path.join(root, f"{i:02d}_align.ply"), np.zeros((10475, 3)))
        img = rng.integers(0, 255, size=(120, 160, 3), dtype=np.uint8)
        Image.fromarray(img).resize((1600, 1200)).save(os.path.join(root, f"{i:02d}_img.png"))
    ds = EHF(img_size=56, annotations_dir="scratch")
    R = _rotvec_to_rotmat_np(EHF_CAM_ROTVEC)
    for i in range(len(ds)):
        x, annot = ds[i]
        out = jm.forward(params, x[None], annot["K"][None], det_thresh=0.2)
        v_cam = np.asarray(jm.extract_persons(out)[0][0]["v3d"], np.float64)
        write_ply_binary(os.path.join(root, annot["imagename"].replace("img.png", "align.ply")),
                         ((v_cam - EHF_CAM_T) @ R).astype(np.float32))


def _metrics(name):
    with open(os.path.join("logs", name, "metrics.jsonl")) as f:
        return {r["tag"].split("/")[1]: r["value"] for r in map(json.loads, f)}


def test_train_pretrained_reference_matches_jax(tmp_path, monkeypatch, capsys):
    from multihmr_tpu.cli import train as jtrain
    from multihmr_tpu.factory import smplx_like_synthetic as jsmplx_like
    from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR
    from multihmr_tpu_torch.cli import train as ttrain

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SMPLX_DIR", raising=False)
    jcfg, _ = _slice_cfgs()
    _tempered_file("multiHMR_ref.pt", jcfg, seed=4)
    params = jckpt.convert_torch_checkpoint("multiHMR_ref.pt", jcfg)
    _self_consistent_ehf(JMultiHMR(jcfg, jsmplx_like(10)), params)
    argv = VITS + ["--valset", "ehf", "--eval_only", "1", "--amp", "0",
                   "--pretrained", "multiHMR_ref.pt"]
    ttrain.main(argv + ["--device", "cpu", "--name", "port"])
    monkeypatch.setattr(sys, "argv", ["train"] + argv + ["--name", "jax"])
    jtrain.main()
    assert "eval[ehf-test] epoch 0" in capsys.readouterr().out
    got, want = _metrics("port"), _metrics("jax")
    assert sorted(got) == sorted(want)
    for k in ("precision", "recall", "f1_score", "n_images"):
        assert got[k] == want[k], k
    assert got["recall"] == 100.0  # every GT person found: the file's weights ran
    assert abs(got["pve"] - want["pve"]) <= 1e-3 * max(abs(want["pve"]), 1.0)
    assert abs(got["pa_pve"] - want["pa_pve"]) <= 1e-2 and got["pa_pve"] < 0.1


def test_build_model_anny_names_m8():
    """The Anny family (ROADMAP M8) is ported: an Anny-family name builds the
    Anny system, as the JAX factory's dispatch does (tests/test_torch_anny_io.py
    holds it to the JAX package)."""
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.models.multihmr_anny import MultiHMRAnny
    from tests.test_torch_anny import _tiny_cfgs

    model = build_model("multiHMR_672_L_anny", device="cpu", cfg=_tiny_cfgs()[1])
    assert isinstance(model, MultiHMRAnny) and len(model.body_model.bone_labels) == 163
