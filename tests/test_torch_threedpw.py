"""The port's 3DPW evaluation against the JAX package's, on the CPU.

The SMPL pkls are synthetic (6,890 vertices, 24 joints; the female's shape
directions negated), written by the test in the official layout: a
scipy-sparse J_regressor, posedirs ``[V, 3, 207]``, and ``v_template`` and
``shapedirs`` as pickled chumpy objects, which both loaders read without
chumpy. Tolerances, each relative to the largest magnitude compared:

  * ``load_smpl_pkl``, ``load_smplx2smpl``, ``load_j_regressor_h36m``: equal;
  * ``rigid_points_registration``: R, s, t within 1e-5 (fp32 SVDs of 3 x 3);
  * ``make_smpl_gt_forward`` and ``THREEDPW.build_dataset`` (root poses and
    translations): 1e-5, fp32 LBS with sums in other orders;
  * ``evaluate_dataset`` with ``smplx2smpl`` and ``J_regressor_h36m``, on a
    3DPW tree whose GT persons are the JAX model's own predictions (so that
    they are matched): every metric within rtol 1e-5 and 1e-4 of its
    magnitude, the bound tests/test_torch_evaluate.py puts on its GT
    forwards.
"""

import contextlib
import copy
import io
import os
import pickle
import shutil
import sys
import types

import numpy as np
import pytest
import scipy.sparse
import jax
import jax.numpy as jnp
import torch

from multihmr_tpu import config as jconfig
from multihmr_tpu.bodymodel import assets as jassets
from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
from multihmr_tpu.data.threedpw import THREEDPW as JTHREEDPW
from multihmr_tpu.io.checkpoint import convert_torch_checkpoint
from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR
from multihmr_tpu.ops.rotations import rigid_points_registration as jrigid
from multihmr_tpu.train import evaluate as jeval
from multihmr_tpu.train import metrics as jmetrics
from multihmr_tpu_torch import config as tconfig
from multihmr_tpu_torch.bodymodel import assets as tassets
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.data.threedpw import THREEDPW
from multihmr_tpu_torch.io.checkpoint import convert_reference_checkpoint
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from multihmr_tpu_torch.ops.rotations import rigid_points_registration
from multihmr_tpu_torch.train import evaluate as teval
from multihmr_tpu_torch.train import metrics as tmetrics
from tests.test_torch_bodymodel import FIELDS
from tests.test_torch_checkpoint import tempered_state_dict
from tests.test_torch_train import BM_ARGS
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

SMPL = dict(num_vertices=6890, num_joints=24, num_extra=0, num_lmk=0)


class _Ch:
    """Pickled as chumpy's ``Ch``: a reader without chumpy gets a stub."""


def _chumpy(arr):
    obj = _Ch.__new__(_Ch)
    obj.__dict__["x"] = arr
    return obj


def write_smpl_pkl(path, gender):
    """A synthetic SMPL in the official pkl layout."""
    a = tassets.synthetic_body_model(**SMPL)
    V = a["v_template"].shape[0]
    sign = 1.0 if gender == "male" else -1.0
    parents = a["parents"].astype(np.int64) % 2**32  # the root's parent as uint32 max
    data = {
        "v_template": _chumpy(a["v_template"].astype(np.float64)),
        "shapedirs": _chumpy(sign * a["shapedirs"].astype(np.float64)),
        "posedirs": a["posedirs"].T.reshape(V, 3, -1),
        "J_regressor": scipy.sparse.csc_matrix(a["J_regressor"].astype(np.float64)),
        "weights": a["lbs_weights"],
        "kintree_table": np.stack([parents, np.arange(len(parents))]).astype(np.uint32),
        "f": a["faces"].astype(np.uint32),
    }
    _Ch.__module__, _Ch.__qualname__ = "chumpy.ch", "Ch"
    mods = {"chumpy": types.ModuleType("chumpy"), "chumpy.ch": types.ModuleType("chumpy.ch")}
    mods["chumpy.ch"].Ch = _Ch
    sys.modules.update(mods)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=2)
    finally:
        for name in mods:
            del sys.modules[name]


@pytest.fixture(scope="module")
def smpl_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    for g in ("male", "female"):
        write_smpl_pkl(str(d / "smpl" / f"SMPL_{g.upper()}.pkl"), g)
    return d


def _layers(smpl_dir):
    """{gender: (JAX body model, port body model)} from the written pkls."""
    out = {}
    for g in ("male", "female"):
        path = str(smpl_dir / "smpl" / f"SMPL_{g.upper()}.pkl")
        out[g] = (jassets.load_smpl_pkl(path),
                  BodyModel.from_arrays(tassets.load_smpl_pkl(path), "cpu"))
    return out


def test_load_smpl_pkl_equal(smpl_dir):
    for g in ("male", "female"):
        path = str(smpl_dir / "smpl" / f"SMPL_{g.upper()}.pkl")
        a, b = jassets.load_smpl_pkl(path), tassets.load_smpl_pkl(path)
        for f in FIELDS:
            x = np.asarray(getattr(a, f))
            assert b[f].dtype == x.dtype and b[f].shape == x.shape, f
            np.testing.assert_array_equal(b[f], x, err_msg=f)
        assert b["posedirs"].shape == (207, 6890 * 3) and b["parents"][0] == -1
        assert b["extra_joint_vertex_ids"].shape == (21,) and b["exprdirs"].shape == (6890, 3, 0)


@pytest.mark.parametrize("form", ["dense", "sparse_dict"])
def test_load_regressors_equal(tmp_path, form):
    rng = np.random.default_rng(0)
    m = rng.random((50, 70)) * (rng.random((50, 70)) < 0.1)
    obj = m if form == "dense" else {"matrix": scipy.sparse.csr_matrix(m)}
    path = str(tmp_path / "smplx2smpl.pkl")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    got, want = tassets.load_smplx2smpl(path), jassets.load_smplx2smpl(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.save(tmp_path / "J_regressor_h36m.npy", m[:17])
    np.testing.assert_array_equal(
        tassets.load_j_regressor_h36m(str(tmp_path / "J_regressor_h36m.npy")),
        jassets.load_j_regressor_h36m(str(tmp_path / "J_regressor_h36m.npy")))


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("case", ["general", "reflected", "coplanar"])
def test_rigid_points_registration_matches_jax(case):
    rng = np.random.default_rng({"general": 0, "reflected": 1, "coplanar": 2}[case])
    x = rng.normal(size=(3, 50, 3))
    if case == "coplanar":
        x[..., 2] = 0.0
    y = 1.7 * x @ _rot(rng).T + rng.normal(size=(3, 1, 3)) + rng.normal(scale=0.01, size=x.shape)
    if case == "reflected":
        y[..., 0] *= -1
    x, y = x.astype(np.float32), y.astype(np.float32)
    want = [np.asarray(a) for a in jrigid(jnp.asarray(x), jnp.asarray(y))]
    got = [a.numpy() for a in rigid_points_registration(torch.from_numpy(x), torch.from_numpy(y))]
    for name, a, b in zip("Rst", got, want):
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0), name
    R, s, t = got
    assert np.allclose(np.linalg.det(R), 1.0, atol=1e-5)  # proper rotations, every case
    # the PA metric (a float64 numpy copy of the same algorithm) agrees
    aligned = s[:, None, None] * np.einsum("bij,bnj->bni", R, x) + t[:, None]
    pa = 1000 * np.linalg.norm(aligned - y, axis=-1).mean(-1)
    np.testing.assert_array_equal(tmetrics.pa_pve(x, y), jmetrics.pa_pve(x, y))
    np.testing.assert_allclose(tmetrics.pa_pve(x, y), pa, rtol=1e-4, atol=1e-3)


def _humans(rng, genders):
    return [{"smpl_root_pose": rng.normal(scale=0.5, size=(1, 3)).astype(np.float32),
             "smpl_body_pose": rng.normal(scale=0.3, size=(23, 3)).astype(np.float32),
             "smpl_shape": rng.normal(size=10).astype(np.float32),
             "smpl_transl": (rng.normal(size=3) + [0, 0, 6]).astype(np.float32),
             "smpl_gender": g} for g in genders]


def test_make_smpl_gt_forward_matches_jax(smpl_dir):
    layers = _layers(smpl_dir)
    rng = np.random.default_rng(3)
    annot = {"humans": _humans(rng, ["male", "female", "female", "male", "male",
                                     "female", "male"]),
             "K": np.array([[60.0, 0, 28], [0, 60, 28], [0, 0, 1]], np.float32)}
    want = jeval.make_smpl_gt_forward({g: j for g, (j, _) in layers.items()}, capacity=3)(annot)
    got = teval.make_smpl_gt_forward({g: t for g, (_, t) in layers.items()}, capacity=3)(annot)
    for k in ("v3d", "j3d", "j2d"):
        assert got[k].shape == want[k].shape and got[k].shape[0] == 7, k
        assert np.abs(got[k] - want[k]).max() <= 1e-5 * np.abs(want[k]).max(), k
    # persons keep their order: person 1 (female) differs from a male forward of it
    male_only = teval.make_smpl_gt_forward({"male": layers["male"][1]}, capacity=3)(
        {**annot, "humans": [dict(h, smpl_gender="male") for h in annot["humans"]]})
    assert np.abs(male_only["v3d"][1] - got["v3d"][1]).max() > 1e-3
    np.testing.assert_array_equal(male_only["v3d"][0], got["v3d"][0])


def _write_3dpw(root, meta, img_hw, n_img):
    from PIL import Image

    os.makedirs(os.path.join(root, "sequenceFiles", "test"), exist_ok=True)
    os.makedirs(os.path.join(root, "imageFiles", "seq0"), exist_ok=True)
    with open(os.path.join(root, "sequenceFiles", "test", "seq0.pkl"), "wb") as f:
        pickle.dump(meta, f)
    rng = np.random.default_rng(4)
    for k in range(n_img):
        small = rng.integers(0, 255, size=(img_hw[0] // 10, img_hw[1] // 10, 3), dtype=np.uint8)
        Image.fromarray(small).resize((img_hw[1], img_hw[0])).save(
            os.path.join(root, "imageFiles", "seq0", f"image_{k:05d}.jpg"))


def test_build_dataset_matches_jax(tmp_path, smpl_dir):
    """Two persons of both genders over 4 frames (the last without an image
    file, one pose invalid), moving cameras: the camera rotation baked into
    the root, the translation recomputed."""
    rng = np.random.default_rng(5)
    T = 4
    cam = np.tile(np.eye(4), (T, 1, 1))
    for k in range(T):
        cam[k, :3, :3] = _rot(rng)
        cam[k, :3, 3] = rng.normal(size=3)
    meta = {
        "poses": [rng.normal(scale=0.3, size=(T, 72)).astype(np.float32) for _ in range(2)],
        "trans": [(rng.normal(size=(T, 3)) + [0, 0, 4]).astype(np.float32) for _ in range(2)],
        "betas": [rng.normal(size=10).astype(np.float32) for _ in range(2)],
        "genders": ["m", "f"],
        "campose_valid": [np.ones(T), np.array([1, 1, 0, 1])],
        "cam_poses": cam,
        "cam_intrinsics": np.array([[1960.0, 0, 540], [0, 1960, 960], [0, 0, 1]]),
    }
    root = str(tmp_path / "3DPW")
    _write_3dpw(root, meta, (1920, 1080), T - 1)
    kw = dict(img_size=56, root_dir=root, smpl_dir=str(smpl_dir), force_build_dataset=True)
    want = JTHREEDPW(annotations_dir=str(tmp_path / "a_jax"), **kw)
    got = THREEDPW(annotations_dir=str(tmp_path / "a_port"), **kw)
    assert got.imagenames == want.imagenames and len(got) == 3
    assert [len(got.annots[n]["humans"]) for n in got.imagenames] == [2, 2, 1]
    for name in got.imagenames:
        a, b = want.annots[name], got.annots[name]
        for k in ("focal", "princpt", "size"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        for ha, hb in zip(a["humans"], b["humans"]):
            assert hb["smpl_gender"] == ha["smpl_gender"]
            for k in ("smpl_body_pose", "smpl_shape"):
                np.testing.assert_array_equal(hb[k], ha[k], err_msg=k)
            for k in ("smpl_root_pose", "smpl_transl"):
                assert hb[k].dtype == np.float32 and hb[k].shape == ha[k].shape, k
                assert np.abs(hb[k] - ha[k]).max() <= 1e-5 * max(np.abs(ha[k]).max(), 1.0), k
    # the cached annotations reload; n before subsample
    again = THREEDPW(img_size=56, root_dir=root, annotations_dir=str(tmp_path / "a_port"), n=2,
                     subsample=2)
    assert again.imagenames == got.imagenames[:2][::2]
    x, annot = got[1]
    xj, annot_j = want[1]
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(annot["K"], annot_j["K"])
    assert [int(h["smpl_gender_id"]) for h in annot["humans"]] == [1, 2]


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX model, params, port model) on one tempered reference state dict,
    built once a module; the cases only read them."""
    vit = dict(embed_dim=32, depth=2, num_heads=2)
    kw = dict(img_size=56, max_people=4, compute_dtype="float32")
    jcfg = jconfig.ModelConfig(vit_override=jconfig.ViTConfig(**vit), **kw)
    tcfg = tconfig.ModelConfig(vit_override=tconfig.ViTConfig(**vit), **kw)
    sd = tempered_state_dict(jcfg, 0)
    params = convert_torch_checkpoint(sd, jcfg)
    net = MultiHMRNet(tcfg)
    net.load_state_dict(convert_reference_checkpoint(sd, tcfg), strict=True)
    tm = MultiHMR(tcfg, BodyModel.from_arrays(tassets.synthetic_body_model(**BM_ARGS), "cpu"),
                  net=net)
    return JMultiHMR(jcfg, jsynthetic(**BM_ARGS)), params, tm


def _self_consistent_3dpw(tmp_path, smpl_dir, jm, params):
    """A 3DPW tree (2 frames of 1080 x 1920, static camera) whose two GT
    persons per frame, male then female, are the JAX model's first two
    predictions: their first 24 rotations, zero shape, and the translation
    that puts the SMPL pelvis on the predicted one."""
    T = 2
    meta = {"poses": [np.zeros((T, 72), np.float32) for _ in range(2)],
            "trans": [np.zeros((T, 3), np.float32) for _ in range(2)],
            "betas": [np.zeros(10, np.float32) for _ in range(2)],
            "genders": ["m", "f"], "campose_valid": [np.ones(T)] * 2,
            "cam_poses": np.tile(np.eye(4), (T, 1, 1)),
            "cam_intrinsics": np.array([[1960.0, 0, 540], [0, 1960, 960], [0, 0, 1]])}
    root = str(tmp_path / "3DPW")
    _write_3dpw(root, meta, (1920, 1080), T)
    ds = JTHREEDPW(img_size=56, root_dir=root, annotations_dir=str(tmp_path / "a0"),
                   smpl_dir=str(smpl_dir))
    for k in range(T):
        x, annot = ds[k]
        out = jm.forward(params, jnp.asarray(x[None]), jnp.asarray(annot["K"][None]),
                         det_thresh=0.2)
        persons = jm.extract_persons(out)[0]
        assert len(persons) >= 2
        for i, g in enumerate(("male", "female")):
            a = tassets.load_smpl_pkl(str(smpl_dir / "smpl" / f"SMPL_{g.upper()}.pkl"))
            pelvis_rest = a["J_regressor"][0] @ a["v_template"]
            meta["poses"][i][k] = np.asarray(persons[i]["rotvec"])[:24].reshape(72)
            meta["trans"][i][k] = np.asarray(persons[i]["transl_pelvis"]).reshape(3) - pelvis_rest
    _write_3dpw(root, meta, (1920, 1080), 0)
    kw = dict(img_size=56, root_dir=root, smpl_dir=str(smpl_dir), force_build_dataset=True)
    return (JTHREEDPW(annotations_dir=str(tmp_path / "a_jax"), **kw),
            THREEDPW(annotations_dir=str(tmp_path / "a_port"), **kw))


def test_evaluate_3dpw_matches_jax(tmp_path, smpl_dir, tiny_pair):
    jm, params, tm = tiny_pair
    ds_j, ds_t = _self_consistent_3dpw(tmp_path, smpl_dir, jm, params)
    rng = np.random.default_rng(6)
    s2s = rng.random((6890, 64)).astype(np.float32)
    s2s /= s2s.sum(1, keepdims=True)
    jreg = rng.random((17, 6890)).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    layers = _layers(smpl_dir)
    kw = dict(det_thresh=0.2, smplx2smpl=s2s, J_regressor_h36m=jreg, log_every=0)
    want = jeval.evaluate_dataset(jm, params, ds_j, gt_forward=jeval.make_smpl_gt_forward(
        {g: j for g, (j, _) in layers.items()}, capacity=4), **kw)
    got = teval.evaluate_dataset(tm, ds_t, gt_forward=teval.make_smpl_gt_forward(
        {g: t for g, (_, t) in layers.items()}, capacity=4), **kw)
    assert sorted(got) == sorted(want) and sorted(got["timings"]) == sorted(want["timings"])
    assert got["recall"] == 100.0 and got["n_images"] == want["n_images"] == 2
    for k in ("pve", "pa_pve", "mpjpe", "pa_mpjpe", "precision", "recall", "f1_score"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4 * abs(want[k]),
                                   err_msg=k)
    assert 0 < got["pa_mpjpe"] < got["mpjpe"]


def test_h36m_regressor_without_smplx2smpl_raises(tiny_pair):
    """A guard where the JAX package fails inside an einsum at its first
    match: SMPL-X predictions need ``smplx2smpl`` before the H36M
    regressor."""
    _, _, tm = tiny_pair
    with pytest.raises(ValueError, match="pass smplx2smpl"):
        teval.evaluate_dataset(tm, [], J_regressor_h36m=np.zeros((17, 6890), np.float32))


# ---- the training CLI's --valset 3dpw (tests/test_cli_train.py, JAX) ----


def _cli_patches(mp):
    """No ``$SMPLX_DIR``, and the CLI's synthetic body model cut to
    ``BM_ARGS``, through the monkeypatch ``mp``."""
    import multihmr_tpu_torch.factory as tfactory

    mp.delenv("SMPLX_DIR", raising=False)
    small = dict(BM_ARGS)
    mp.setattr(tfactory, "smplx_like_synthetic", lambda nb: tassets.synthetic_body_model(
        num_betas=max(nb, 11), **small))


CLI_ARGV = ["--backbone", "dinov2_vits14", "--img_size", "56", "--xat_depth", "1",
            "--max_people", "4", "--n_devices", "1", "--device", "cpu",
            "--valset", "3dpw", "--eval_only", "1", "--name", "itest-3dpw"]


@pytest.fixture(scope="module")
def skipped_3dpw(tmp_path_factory):
    """A 3DPW tree without smplx2smpl.pkl and the CLI's evaluation of it, run
    once a module in that tree: (the tree, the rng that wrote it, stdout).
    Both layouts of test_train_cli_eval_only_3dpw continue from a copy."""
    from multihmr_tpu_torch.cli.train import main
    from tests.test_cli_train import _write_threedpw

    root = tmp_path_factory.mktemp("skipped_3dpw")
    rng = np.random.default_rng(2)
    _write_threedpw(root, rng)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        _cli_patches(mp)
        mp.chdir(root)
        main(CLI_ARGV)
    return root, rng, out.getvalue()


@pytest.mark.parametrize("layout", ["flat", "reference"])
def test_train_cli_eval_only_3dpw(skipped_3dpw, tmp_path, monkeypatch, capsys, layout):
    from multihmr_tpu_torch.cli.train import main

    root, rng, out = skipped_3dpw
    rng = copy.deepcopy(rng)  # where writing the tree left it
    # no smplx2smpl.pkl: the valset is skipped with its reason
    assert "3dpw eval SKIPPED" in out and "eval[3dpw" not in out
    shutil.copytree(root, tmp_path, dirs_exist_ok=True)
    monkeypatch.chdir(tmp_path)
    _cli_patches(monkeypatch)

    sub = "smplx" if layout == "reference" else ""
    os.makedirs(os.path.join("models", sub), exist_ok=True)
    with open(os.path.join("models", sub, "smplx2smpl.pkl"), "wb") as f:
        pickle.dump({"matrix": rng.random((6890, 64)).astype(np.float32) / 64}, f)
    jr_dir = os.path.join("models", "smpl" if layout == "reference" else "")
    os.makedirs(jr_dir, exist_ok=True)
    np.save(os.path.join(jr_dir, "J_regressor_h36m.npy"),
            rng.random((17, 6890)).astype(np.float32) / 6890)
    if layout == "reference":
        for g in ("male", "female"):
            write_smpl_pkl(os.path.join("models", "smpl", f"SMPL_{g.upper()}.pkl"), g)
    main(CLI_ARGV)
    out = capsys.readouterr().out
    assert "eval[3dpw-test] epoch 0" in out
    assert "'n_images': 2" in out.split("eval[3dpw-test]")[1][:400]
    assert "mpjpe" in out.split("eval[3dpw-test]")[1]
    assert ("synthetic female SMPL" in out) == (layout == "flat")
