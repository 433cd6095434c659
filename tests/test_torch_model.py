"""The port's whole slice against the JAX package, on a tiny configuration.

``TinyConfig`` of tests/test_checkpoint.py (ViT 32 wide, 2 deep, 56 x 56,
K = 4 slots) in fp32, with the weights of ``make_reference_state_dict``
going through the JAX converter and then ``params_from_jax``. Two weight
sets, each with its measured errors (relative to the output's largest
magnitude) and the tolerance held:

  * "unit": the state dict as made, unit-normal weights. Activations reach
    1e4-1e5 and the sigmoid saturates, so detections tie: they must be
    equal. Head outputs (shape, expression, loc, dist) measured 7e-5, held
    to 2e-4: the JAX head LayerNorms compute E[x^2] - E[x]^2 in fp32 on
    values of 1e4 and lose digits there. Rotations, meshes and joints
    measured 1.1e-3, held to 3e-3: Gram-Schmidt of 6d vectors of norm 1e5
    amplifies that. j2d is not compared here (points at ~0 depth).
  * "tempered": the same weights scaled by fan_in^-0.5, activations O(1).
    Everything measured <= 7e-6, held to 1e-4, except j2d: 2.3e-4, held to
    1e-3 (people regress to 5 cm from the camera, so the projection divides
    by small depths).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
from multihmr_tpu.io.checkpoint import convert_torch_checkpoint
from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR
from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.io.convert import params_from_jax
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from tests.test_checkpoint import TinyConfig, make_reference_state_dict

REPO = Path(__file__).resolve().parents[1]
HEAD = ("scores", "scores_det", "loc", "dist", "shape", "expression", "transl")
GEOM = ("rotvec", "v3d", "j3d")
TOLS = {
    "unit": {**dict.fromkeys(HEAD, 2e-4), **dict.fromkeys(GEOM, 3e-3)},
    "tempered": {**dict.fromkeys(HEAD + GEOM, 1e-4), "j2d": 1e-3},
}


def _tiny_cfg(max_people=4, person_center="j5"):
    return TinyConfig(img_size=56, max_people=max_people, person_center=person_center,
                      compute_dtype="float32")


@pytest.fixture(scope="module", params=["unit", "tempered"])
def slice_pair(request):
    """(weights name, cfg, JAX params, JAX model, port model) on the same weights."""
    cfg = _tiny_cfg()
    sd = make_reference_state_dict(cfg, np.random.default_rng(0))
    if request.param == "tempered":
        for k, v in sd.items():
            if k.endswith("weight") and v.ndim >= 2:
                sd[k] = (v / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
    params = convert_torch_checkpoint({"model_state_dict": sd}, cfg)
    jbm = jsynthetic()
    names = [f"j{i}" for i in range(jbm.num_output_joints)]
    jm = JMultiHMR(cfg, jbm, person_center_joint_names=names)
    net = MultiHMRNet(cfg)
    net.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    tm = MultiHMR(cfg, BodyModel.from_arrays(synthetic_body_model(), "cpu"), net=net,
                  person_center_joint_names=names)
    return request.param, cfg, params, jm, tm


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    assert (np.isnan(a) == np.isnan(b)).all()
    return np.abs(np.where(both_nan, 0, a - b)).max() / max(np.nanmax(np.abs(a)), 1.0)


def test_slice_matches_jax(slice_pair, rng):
    weights, cfg, params, jm, tm = slice_pair
    x = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
    K = np.array([[[100.0, 0, 28], [0, 100, 28], [0, 0, 1]]] * 2, np.float32)
    fwd = jax.jit(lambda p, x, K: jm.forward(p, x, K, batch_mode="fused"))
    a = fwd(params, x, K)
    with torch.inference_mode():
        b = tm.forward(torch.from_numpy(x), torch.from_numpy(K))
    for f in ("rows", "cols", "valid"):
        np.testing.assert_array_equal(getattr(b["det"], f).numpy(),
                                      np.asarray(getattr(a["det"], f)), err_msg=f)
    for k, tol in TOLS[weights].items():
        assert b[k].shape == a[k].shape, k
        err = _rel_err(a[k], b[k].numpy())
        assert err <= tol, (k, err)
    pa = jm.extract_persons(a)
    pb = tm.extract_persons(b)
    assert [len(p) for p in pb] == [len(p) for p in pa]
    for img_a, img_b in zip(pa, pb):
        for per_a, per_b in zip(img_a, img_b):
            assert sorted(per_a) == sorted(per_b)
            assert _rel_err(per_a["v3d"], per_b["v3d"]) <= TOLS[weights]["v3d"]


def test_params_from_jax_maps_every_leaf(slice_pair):
    _, cfg, params, _, _ = slice_pair
    tree = jax.device_get(params)
    sd = params_from_jax(tree, cfg)
    # scanned blocks unstacked, Dense kernels transposed
    qkv = np.asarray(tree["params"]["backbone"]["blocks"]["block"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["backbone.blocks.1.attn.qkv.weight"].numpy(), qkv[1].T)
    pe = np.asarray(tree["params"]["backbone"]["patch_embed"]["kernel"])
    np.testing.assert_array_equal(sd["backbone.patch_embed.weight"].numpy(), pe.T)
    # an extra leaf and a missing leaf both raise
    extra = {"params": dict(tree["params"], stray={"kernel": np.zeros((2, 2))})}
    with pytest.raises(KeyError, match="stray"):
        params_from_jax(extra, cfg)
    missing = {"params": {k: v for k, v in tree["params"].items() if k != "mlp_offset"}}
    with pytest.raises(KeyError, match="mlp_offset"):
        params_from_jax(missing, cfg)


def test_demo_main_writes_persons(tmp_path, monkeypatch):
    from PIL import Image

    import multihmr_tpu_torch.factory as factory
    from multihmr_tpu_torch.cli import demo

    cfg = _tiny_cfg(max_people=3, person_center="head")
    monkeypatch.setattr(factory, "named_config", lambda name: cfg)
    small = synthetic_body_model(num_joints=55, num_vertices=64, num_extra=21, num_lmk=51)
    monkeypatch.setattr(factory, "smplx_like_synthetic", lambda nb: small)
    src = tmp_path / "in"
    src.mkdir()
    img = np.random.default_rng(0).integers(0, 256, size=(40, 48, 3), dtype=np.uint8)
    Image.fromarray(img).save(src / "im0.png")
    out = tmp_path / "out"
    demo.main(["--img_folder", str(src), "--out_folder", str(out),
               "--model_name", "multiHMR_672_S", "--device", "cpu",
               "--det_thresh", "0.0", "--save_mesh", "1"])
    rec = json.loads((out / "im0.png_multiHMR_672_S.json").read_text())
    assert rec["image"] == "im0.png" and len(rec["persons"]) == 3
    assert len(rec["persons"][0]["j3d"]) == 127 and "v3d" not in rec["persons"][0]
    meshes = np.load(out / "im0.png_multiHMR_672_S.npy")
    assert meshes.shape == (3, 64, 3) and np.isfinite(meshes).all()
    with pytest.raises(SystemExit):
        demo.main(["--img_folder", str(src), "--ckpt", "x.pt", "--device", "cpu"])


def test_port_imports_without_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "multihmr_tpu_torch").rglob("*.py")
    )
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\nsys.modules['flax'] = None\n"
        "sys.modules['multihmr_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "assert not any(k in ('jax', 'multihmr_tpu') or k.startswith(('jax.', 'flax', 'multihmr_tpu.')) "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
