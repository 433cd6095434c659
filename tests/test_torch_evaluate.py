"""``train/evaluate.py`` against the JAX package's on the same weights.

``TinyConfig`` of tests/test_training.py (ViT 32 wide, 2 deep, 56 x 56,
K = 4 slots) in fp32, JAX-initialised weights carried across by
``params_from_jax``, the synthetic body model with SMPL-X's joint layout
(64 vertices, 55 joints; 11 betas for the BEDLAM GT forward), and
``det_thresh`` 0 so every slot is a detection.

  * EHF: a synthetic tree whose GT mesh on each image is the JAX model's own
    first person, written back through the EHF camera into its world frame,
    so the matcher pairs persons and the mesh errors are real numbers.
  * BEDLAM validation: the tree of tests/test_cli_train.py, GT meshes from
    its SMPL-X parameters through each package's GT forward.

The detections must be equal first. Then precision, recall, F1 and the
image count equal exactly, PVE within 1e-3 relative (fp32 forwards that
agree to ~1e-6 relative, tests/test_torch_train.py), PA-PVE within 1e-2 mm
(the self-consistent EHF meshes align to ~0 on the JAX side and to the
port's fp32 differences on the other), and the same timing keys.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR
from multihmr_tpu.train import evaluate as jeval
from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.data.bedlam import BEDLAM
from multihmr_tpu_torch.data.ehf import EHF, EHF_CAM_ROTVEC, EHF_CAM_T, _rotvec_to_rotmat_np
from multihmr_tpu_torch.io.convert import params_from_jax
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from multihmr_tpu_torch.train import evaluate as teval
from tests.test_cli_train import _write_bedlam
from tests.test_datasets import write_ply_binary
from tests.test_torch_train import BM_ARGS, _cfg
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    jm = JMultiHMR(cfg, jsynthetic(**BM_ARGS))
    params = jm.init_params(jax.random.PRNGKey(0))
    net = MultiHMRNet(cfg)
    net.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    tm = MultiHMR(cfg, BodyModel.from_arrays(synthetic_body_model(**BM_ARGS), "cpu"), net=net)
    return jm, params, tm


def _self_consistent_ehf(tmp_path, jm, params):
    """EHF tree whose GT meshes are the JAX model's own first persons."""
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path / "EHF"
    root.mkdir()
    for i in range(2):
        write_ply_binary(root / f"{i:02d}_align.ply", np.zeros((64, 3), np.float32))
        Image.fromarray(rng.integers(0, 255, size=(90, 120, 3), dtype=np.uint8)).save(
            root / f"{i:02d}_img.png")
    ds = EHF(img_size=56, root_dir=str(root), annotations_dir=str(tmp_path / "a0"))
    R = _rotvec_to_rotmat_np(EHF_CAM_ROTVEC)
    for i in range(len(ds)):
        x, annot = ds[i]
        out = jm.forward(params, jnp.asarray(x[None]), jnp.asarray(annot["K"][None]),
                         det_thresh=0.0)
        v_cam = np.asarray(jm.extract_persons(out)[0][0]["v3d"], np.float64)
        write_ply_binary(root / annot["imagename"].replace("img.png", "align.ply"),
                         ((v_cam - EHF_CAM_T) @ R).astype(np.float32))
    return EHF(img_size=56, root_dir=str(root), annotations_dir=str(tmp_path / "a1"))


def _bedlam(tmp_path):
    _write_bedlam(tmp_path / "BEDLAM", np.random.default_rng(1), split="validation")
    return BEDLAM(split="validation", img_size=56, root_dir=str(tmp_path / "BEDLAM"),
                  annotations_dir=str(tmp_path / "a2"))


@pytest.mark.parametrize("valset", ["ehf", "bedlam"])
def test_evaluate_matches_jax(tmp_path, models, valset):
    jm, params, tm = models
    if valset == "ehf":
        ds = _self_consistent_ehf(tmp_path, jm, params)
        j_gt = t_gt = None
    else:
        ds = _bedlam(tmp_path)
        j_gt = jeval.make_smplx_gt_forward(jsynthetic(**BM_ARGS, num_betas=11), num_betas=11,
                                           capacity=4)
        t_gt = teval.make_smplx_gt_forward(
            BodyModel.from_arrays(synthetic_body_model(**BM_ARGS, num_betas=11), "cpu"), 11)
        annot = ds[0][1]
        a, b = j_gt(annot), t_gt(annot)
        for k in ("v3d", "j3d", "j2d"):  # the GT forwards agree
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-4 * np.abs(a[k]).max())
    # equal detections first
    for i in range(len(ds)):
        x, annot = ds[i]
        a = jm.forward(params, jnp.asarray(x[None]), jnp.asarray(annot["K"][None]), det_thresh=0.0)
        with torch.inference_mode():
            b = tm.forward(torch.from_numpy(x[None]), torch.from_numpy(annot["K"][None]),
                           det_thresh=0.0)
        for f in ("rows", "cols", "valid"):
            np.testing.assert_array_equal(getattr(b["det"], f).numpy(),
                                          np.asarray(getattr(a["det"], f)), err_msg=f)
    want = jeval.evaluate_dataset(jm, params, ds, det_thresh=0.0, gt_forward=j_gt, log_every=0)
    got = teval.evaluate_dataset(tm, ds, det_thresh=0.0, gt_forward=t_gt, log_every=0)
    assert sorted(got) == sorted(k for k in want if k not in ("mpjpe", "pa_mpjpe"))
    assert sorted(got["timings"]) == sorted(want["timings"])
    for k in ("precision", "recall", "f1_score", "n_images"):
        assert got[k] == want[k], k
    assert abs(got["pve"] - want["pve"]) <= 1e-3 * max(abs(want["pve"]), 1.0)
    assert abs(got["pa_pve"] - want["pa_pve"]) <= 1e-2
    if valset == "ehf":  # every GT person found, on its own mesh
        assert got["recall"] == 100.0 and got["pa_pve"] < 0.1 and got["pve"] > 0


@pytest.mark.parametrize("max_images", [1, 2])
def test_pipelined_and_serial_agree(tmp_path, models, max_images):
    """The pipelined loop (taken with a ``gt_forward``) and the serial one
    (EHF's vertex GT read natively) give the same metrics, with one image in
    flight at the end and with two."""
    jm, params, tm = models
    ds = _self_consistent_ehf(tmp_path, jm, params)
    j_reg = tm.body_model.J_regressor.cpu().numpy()

    def vertex_gt(annot):  # what the serial loop computes from the vertices
        verts = np.stack([h["smplx_vertices"] for h in annot["humans"]])
        j3d = np.einsum("jv,pvc->pjc", j_reg, verts)
        return {"v3d": verts, "j3d": j3d,
                "j2d": teval._project_np(j3d, annot["K"]).astype(np.float32)}

    a = teval.evaluate_dataset(tm, ds, det_thresh=0.0, log_every=0, max_images=max_images)
    b = teval.evaluate_dataset(tm, ds, det_thresh=0.0, log_every=0, max_images=max_images,
                               gt_forward=vertex_gt)
    assert a["n_images"] == max_images
    assert {k: v for k, v in a.items() if k != "timings"} == \
        {k: v for k, v in b.items() if k != "timings"}


def test_no_gt_raises(models):
    _, _, tm = models
    ds = [(np.zeros((56, 56, 3), np.float32),
           {"K": np.eye(3, dtype=np.float32), "humans": [{"smpl_pose": 0}]})]
    with pytest.raises(ValueError, match="no GT"):
        teval.evaluate_dataset(tm, ds, det_thresh=0.0, log_every=0)
