"""The Anny family's loaders and entry points against the JAX package, on the CPU.

  * ``io/checkpoint.py::convert_reference_checkpoint_anny`` gives tensors
    **equal** (max |diff| = 0) to the JAX package's
    ``convert_torch_checkpoint_anny`` followed by ``params_from_jax_anny``,
    drops ``body_model.*``, ignores ``useful_rotmat``, and raises the JAX
    ``KeyError`` text for a missing key;
  * ``factory.build_model`` for an Anny name: seeded init, ``checkpoint=``
    and the ``$ANNY_NPZ`` asset, with the configuration swapped for
    ``tests/test_anny.py::tiny_anny``'s;
  * ``cast_backbone_bf16`` reaches ``net.encoder.backbone``;
  * ``cli/demo.py --model_name multiHMR_672_L_anny``, with and without
    ``--ckpt``: with the file, each person's ``v3d`` within 1e-4 of the
    largest magnitude of the JAX model's on the same weights, image and K
    (``TOLS["tempered"]`` of tests/test_torch_anny.py);
  * ``tools/convert_anny.py::convert`` on a synthetic source, as
    tests/test_anny_convert.py, its ``.npz`` loading equal in the JAX
    package.
"""

import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihmr_tpu.bodymodel import anny as janny
from multihmr_tpu.io import checkpoint as jckpt
from multihmr_tpu_torch.bodymodel import anny as tanny
from multihmr_tpu_torch.io import checkpoint as tckpt
from multihmr_tpu_torch.io.convert import params_from_jax_anny
from multihmr_tpu_torch.models.multihmr_anny import MultiHMRAnny, MultiHMRAnnyNet
from tests.test_anny_checkpoint import make_anny_state_dict
from tests.test_torch_anny import TOLS, _assert_same_anny, _tiny_cfgs, tempered
from tests.test_torch_checkpoint import _assert_equal
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

ANNY = "multiHMR_672_L_anny"


def _cfgs(depth):
    jcfg, tcfg = _tiny_cfgs()
    jv = dataclasses.replace(jcfg.vit_override, depth=depth)
    tv = dataclasses.replace(tcfg.vit_override, depth=depth)
    return (dataclasses.replace(jcfg, vit_override=jv, xat_depth=2),
            dataclasses.replace(tcfg, vit_override=tv, xat_depth=2))


def _jax_port_sd(ckpt, jcfg, tcfg):
    return params_from_jax_anny(jax.device_get(jckpt.convert_torch_checkpoint_anny(ckpt, jcfg)),
                                tcfg)


@pytest.mark.parametrize("depth", [2, 4])
def test_convert_anny_bitwise_equal(depth):
    jcfg, tcfg = _cfgs(depth)
    sd = make_anny_state_dict(jcfg, np.random.default_rng(depth))  # body_model.*, useful_rotmat
    got = tckpt.convert_reference_checkpoint_anny(sd, tcfg)  # a bare state dict
    _assert_equal(got, _jax_port_sd(sd, jcfg, tcfg))
    with torch.device("meta"):
        assert sorted(got) == sorted(MultiHMRAnnyNet(tcfg).state_dict())
    # the file's init_body_pose, not the default one
    np.testing.assert_array_equal(got["init_body_pose"].numpy(), sd["init_body_pose"])


def test_convert_anny_torch_saved_file(tmp_path):
    jcfg, tcfg = _cfgs(2)
    sd = make_anny_state_dict(jcfg, np.random.default_rng(5))
    path = str(tmp_path / f"{ANNY}.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": argparse.Namespace(img_size=[56])}, path)
    _assert_equal(tckpt.convert_reference_checkpoint_anny(path, tcfg),
                  _jax_port_sd(path, jcfg, tcfg))


@pytest.mark.parametrize("key", ["encoder.backbone.blocks.1.ls2.gamma", "mlp_offset.0.weight",
                                 "decoder.transformer.layers.1.1.fn.to_q.weight",
                                 "dec_pos_emb"])
def test_convert_anny_missing_key_carries_the_jax_text(key):
    jcfg, tcfg = _cfgs(2)
    sd = make_anny_state_dict(jcfg, np.random.default_rng(7))
    del sd[key]
    with pytest.raises(KeyError) as a:
        jckpt.convert_torch_checkpoint_anny(sd, jcfg)
    with pytest.raises(KeyError) as b:
        tckpt.convert_reference_checkpoint_anny(sd, tcfg)
    assert str(b.value) == str(a.value) and repr(key) in str(b.value)


def test_expected_keys_anny_equal():
    jcfg, tcfg = _cfgs(2)
    assert tckpt.expected_reference_keys_anny(tcfg) == jckpt.expected_reference_keys_anny(jcfg)
    # every key the converter reads, and nothing more
    sd = make_anny_state_dict(jcfg, np.random.default_rng(1))
    used = {k for k in sd if not k.startswith("body_model") and k != "useful_rotmat"}
    assert used == tckpt.expected_reference_keys_anny(tcfg)


@pytest.fixture
def tiny_factory(monkeypatch, tmp_path):
    """The factory's Anny configuration cut to tiny_anny's, and no asset on
    disk: the synthetic body model, cut to 64 vertices."""
    import multihmr_tpu_torch.factory as factory

    _, tcfg = _tiny_cfgs()
    monkeypatch.setattr(factory, "anny_config", lambda name: tcfg)
    monkeypatch.setattr(factory, "synthetic_anny_model",
                        lambda: tanny.synthetic_anny_model(num_vertices=64))
    monkeypatch.setenv("SMPLX_DIR", str(tmp_path / "no_assets"))
    monkeypatch.delenv("ANNY_NPZ", raising=False)
    return factory, tcfg


def test_build_model_anny(tiny_factory, tmp_path, monkeypatch):
    factory, tcfg = tiny_factory
    a = factory.build_model(ANNY, device="cpu", seed=3)
    b = factory.build_model(ANNY, device="cpu", seed=3)
    assert isinstance(a, MultiHMRAnny) and a.cfg is tcfg
    assert a.body_model.num_vertices == 64 and a.person_center_idx == 15  # "head"
    sa, sb = a.net.state_dict(), b.net.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)  # one seed, one set of weights
    assert not a.net.training and a.net.useful_rotmat.device.type == "cpu"
    # checkpoint=: every tensor from the file, through the meta-device build
    jcfg, _ = _tiny_cfgs()
    sd = make_anny_state_dict(jcfg, np.random.default_rng(2))
    path = str(tmp_path / f"{ANNY}.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    c = factory.build_model(ANNY, device="cpu", checkpoint=path, tp_mode="ring")
    _assert_equal({k: v for k, v in c.net.state_dict().items()},
                  tckpt.convert_reference_checkpoint_anny(path, tcfg))
    assert not c.net.encoder.backbone.transposed  # tp_mode reaches the ViT
    with torch.inference_mode():
        out = c.forward(torch.zeros(1, 56, 56, 3))
    assert torch.isfinite(out["v3d"]).all()
    # $ANNY_NPZ: the converted asset
    npz = str(tmp_path / "anny.npz")
    tanny.save_anny_npz(npz, tanny.AnnyModel.from_arrays(
        tanny.synthetic_anny_model(num_vertices=40, seed=4), "cpu"))
    monkeypatch.setenv("ANNY_NPZ", npz)
    d = factory.build_model(ANNY, device="cpu")
    assert d.body_model.num_vertices == 40
    assert not d.body_model.base.posedirs.any()  # the container's zero pose correctives


def test_cast_backbone_bf16_anny():
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    _, tcfg = _tiny_cfgs()
    net = cast_backbone_bf16(MultiHMRAnnyNet(tcfg))
    bb = net.encoder.backbone
    assert bb.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert bb.patch_embed.weight.dtype == torch.bfloat16
    assert bb.norm.weight.dtype == bb.blocks[0].norm1.weight.dtype == torch.float32
    outside = [n for n, p in net.named_parameters()
               if not n.startswith("encoder.backbone.") and p.dtype != torch.float32]
    assert not outside, outside


def _image_dir(path):
    from PIL import Image

    os.makedirs(path)
    img = np.random.default_rng(1).integers(0, 256, size=(40, 48, 3), dtype=np.uint8)
    Image.fromarray(img).save(os.path.join(path, "im0.png"))
    return img


def test_demo_main_anny(tiny_factory, tmp_path):
    from multihmr_tpu.models.multihmr_anny import MultiHMRAnny as JMultiHMRAnny
    from multihmr_tpu.utils.precision import cast_backbone_bf16
    from multihmr_tpu_torch.cli import demo
    from multihmr_tpu_torch.io.preprocessing import preprocess_array

    _, tcfg = tiny_factory
    src, out = str(tmp_path / "in"), str(tmp_path / "out")
    img = _image_dir(src)
    pre = preprocess_array(img, 56)  # the demo's FOV-60 K
    # seeded weights
    demo.main(["--img_folder", src, "--out_folder", out, "--model_name", ANNY,
               "--device", "cpu", "--det_thresh", "0.0", "--save_mesh", "1"])
    rec = json.loads(open(os.path.join(out, f"im0.png_{ANNY}.json")).read())
    meshes = np.load(os.path.join(out, f"im0.png_{ANNY}.png.npy"))
    assert len(rec["persons"]) == 3 and meshes.shape == (3, 64, 3) and np.isfinite(meshes).all()
    p0 = rec["persons"][0]
    assert {"K", "K_regressed", "fov", "rotmat", "j2d"} <= set(p0) and "v3d" not in p0
    np.testing.assert_allclose(p0["K"], pre.K, rtol=1e-6)
    depths = [p["transl"][2] for p in rec["persons"]]
    assert depths == sorted(depths)

    # a reference-layout file: the JAX model on the same weights, image and K
    jcfg, _ = _tiny_cfgs()
    sd = tempered(make_anny_state_dict(jcfg, np.random.default_rng(0)))
    path = str(tmp_path / "x.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    demo.main(["--img_folder", src, "--out_folder", out, "--model_name", ANNY, "--ckpt", path,
               "--device", "cpu", "--det_thresh", "0.0", "--save_mesh", "1"])
    got = np.load(os.path.join(out, f"im0.png_{ANNY}.png.npy"))
    jm = JMultiHMRAnny(jcfg, janny.synthetic_anny_model(num_vertices=64))
    params = cast_backbone_bf16(jckpt.convert_torch_checkpoint_anny(path, jcfg))
    fwd = jax.jit(lambda p, x, K: jm.forward(p, x, K, det_thresh=0.0, batch_mode="fused"))
    want = jm.extract_persons(fwd(params, pre.x[None], jnp.asarray(pre.K[None])))[0]
    assert got.shape == (len(want), 64, 3) and len(want) == 3
    scale = max(np.abs(p["v3d"]).max() for p in want)
    for p_got, p_want in zip(got, want):
        assert np.abs(p_got - p_want["v3d"]).max() <= TOLS["tempered"]["v3d"] * scale
    # a file whose keys do not fit raises the JAX KeyError before any image
    torch.save({"model_state_dict": {}}, str(tmp_path / "empty.pt"))
    with pytest.raises(KeyError, match="not found"):
        demo.main(["--img_folder", src, "--ckpt", str(tmp_path / "empty.pt"),
                   "--device", "cpu", "--model_name", ANNY])


def _make_source(num_vertices=48, num_bones=18, n_blend=6, seed=3):
    """A synthetic Anny model (no pose correctives, as the real package) as a
    duck-typed package: forward(pose, phen) → numpy dict."""
    arrays = tanny.synthetic_anny_model(num_vertices=num_vertices, num_bones=num_bones,
                                        n_blend=n_blend, num_knots=3, seed=seed)
    arrays["posedirs"] = np.zeros_like(arrays["posedirs"])
    m = tanny.AnnyModel.from_arrays(arrays, "cpu")

    class Source:
        bone_labels = list(m.bone_labels)
        phenotype_labels = list(m.phenotype_labels)
        faces = arrays["faces"]

        def __init__(self):
            self.num_bones = num_bones

        def forward(self, pose, phen):
            with torch.no_grad():
                out = tanny.anny_forward(
                    m, torch.from_numpy(np.asarray(pose, np.float32)),
                    {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in phen.items()})
            return {k: v.numpy() for k, v in out.items()}

    return Source(), arrays


def test_convert_anny_tool(tmp_path):
    from multihmr_tpu_torch.tools.convert_anny import (
        _identity_poses, _phen_dict, _random_rotmats, convert)

    source, truth = _make_source()
    model = convert(source, np.linspace(0.0, 1.0, 3), n_poses=40, validate_n=6, tol=2e-4)
    assert model.base.parents == tuple(int(p) for p in truth["parents"])
    assert model.bone_labels == tuple(truth["bone_labels"])
    rng = np.random.default_rng(7)
    poses = _identity_poses(5, 18)
    poses[:, :, :3, :3] = _random_rotmats(rng, (5, 18), scale=0.5)
    phen = _phen_dict(rng.uniform(0, 1, size=(5, 6)).astype(np.float32))
    want = source.forward(poses, phen)
    with torch.no_grad():
        got = tanny.anny_forward(model, torch.from_numpy(poses),
                                 {k: torch.from_numpy(v) for k, v in phen.items()})
    np.testing.assert_allclose(got["vertices"].numpy(), want["vertices"], atol=3e-4)
    np.testing.assert_allclose(got["bone_poses"].numpy(), want["bone_poses"], atol=3e-4)
    # the container it writes loads equal in the JAX package
    path = str(tmp_path / "anny.npz")
    tanny.save_anny_npz(path, model)
    _assert_same_anny(janny.load_anny_npz(path), tanny.load_anny_npz(path))
