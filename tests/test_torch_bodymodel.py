"""Body-model port: LBS, the camera-aware SMPL-X layer and the asset loaders
against the JAX package.

Geometry runs in fp32 on both sides (the JAX side at precision=HIGHEST).
Tolerance 1e-5 on vertices and joints of O(1) m: fp32 blendshape and
skinning sums in different orders. Projected 2D points are pixels of
O(1e3): 2e-3 there (a few fp32 ulps). The synthetic generator and the
loaders must give equal arrays.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multihmr_tpu.bodymodel import assets as jassets
from multihmr_tpu.bodymodel.core import lbs_forward as jlbs
from multihmr_tpu.factory import smplx_like_synthetic as jsmplx_like
from multihmr_tpu.models.smplx_layer import SMPLXCameraLayer as JLayer
from multihmr_tpu_torch.bodymodel import assets as tassets
from multihmr_tpu_torch.bodymodel import constants as tconst
from multihmr_tpu_torch.bodymodel.core import BodyModel, lbs_forward as tlbs
from multihmr_tpu_torch.models.smplx_layer import SMPLXCameraLayer as TLayer
from multihmr_tpu.bodymodel import constants as jconst
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

FIELDS = ("v_template", "shapedirs", "exprdirs", "posedirs", "J_regressor",
          "lbs_weights", "parents", "extra_joint_vertex_ids", "faces",
          "lmk_faces_idx", "lmk_bary_coords")


def _assert_same_model(jbm, arrays):
    for f in FIELDS:
        a = np.asarray(getattr(jbm, f))
        b = arrays[f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("kw", [
    {}, {"seed": 3}, {"num_vertices": 300, "num_joints": 55, "num_extra": 21, "num_lmk": 51},
])
def test_synthetic_model_equal(kw):
    _assert_same_model(jassets.synthetic_body_model(**kw), tassets.synthetic_body_model(**kw))


def test_smplx_like_synthetic_equal():
    _assert_same_model(jsmplx_like(10), tassets.smplx_like_synthetic(10))


def test_mean_params_and_constants_equal(tmp_path):
    path = tmp_path / "mean.npz"
    rng = np.random.default_rng(1)
    np.savez(path, pose=rng.normal(size=144), shape=rng.normal(size=10), cam=rng.normal(size=3))
    for p in (None, str(path)):
        for nrot, nb in ((53, 10), (53, 11), (24, 10)):
            a = jassets.load_mean_params(p, nrot=nrot, num_betas=nb)
            b = tassets.load_mean_params(p, nrot=nrot, num_betas=nb)
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert tconst.get_smplx_joint_names() == jconst.get_smplx_joint_names()
    assert tconst.extra_joint_vertex_ids("smplx") == jconst.extra_joint_vertex_ids("smplx")
    assert tconst.extra_joint_vertex_ids("smpl") == jconst.extra_joint_vertex_ids("smpl")
    assert (tconst.H36M_TO_J17, tconst.H36M_TO_J14) == (jconst.H36M_TO_J17, jconst.H36M_TO_J14)


def test_load_smplx_npz_equal(tmp_path):
    # an npz with the official asset's keys and layouts, filled from a seed
    rng = np.random.default_rng(2)
    V, J = 40, 55
    path = tmp_path / "SMPLX_NEUTRAL.npz"
    np.savez(
        path,
        v_template=rng.normal(size=(V, 3)), shapedirs=rng.normal(size=(V, 3, 400)),
        posedirs=rng.normal(size=(V, 3, 9 * (J - 1))),
        kintree_table=np.stack([np.arange(J) - 1, np.arange(J)]),
        J_regressor=rng.uniform(size=(J, V)), weights=rng.uniform(size=(V, J)),
        f=rng.integers(0, V, size=(70, 3)), lmk_faces_idx=rng.integers(0, 70, size=51),
        lmk_bary_coords=rng.uniform(size=(51, 3)),
    )
    _assert_same_model(jassets.load_smplx_npz(str(path)), tassets.load_smplx_npz(str(path)))


def _pose(rng, B, J, scale=0.4):
    rv = (rng.normal(size=(B, J, 3)) * scale).astype(np.float32)
    return rv


@pytest.mark.parametrize("with_expression", [True, False])
def test_lbs_forward(rng, with_expression):
    jbm = jassets.synthetic_body_model()
    tbm = BodyModel.from_arrays(tassets.synthetic_body_model(), "cpu")
    from multihmr_tpu.ops.rotations import rotvec_to_rotmat

    rot = np.array(rotvec_to_rotmat(jnp.asarray(_pose(rng, 3, 12))))
    betas = rng.normal(size=(3, 10)).astype(np.float32)
    expr = rng.normal(size=(3, 10)).astype(np.float32) if with_expression else None
    a = jlbs(jbm, jnp.asarray(rot), jnp.asarray(betas),
             None if expr is None else jnp.asarray(expr))
    b = tlbs(tbm, torch.from_numpy(rot), torch.from_numpy(betas),
             None if expr is None else torch.from_numpy(expr))
    for k in ("vertices", "joints", "joints_fk", "world_rot", "rel_t"):
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("smplx_layout", [False, True])
def test_smplx_camera_layer(rng, smplx_layout):
    kw = ({"num_vertices": 200, "num_joints": 55, "num_extra": 21, "num_lmk": 51}
          if smplx_layout else {})
    jbm = jassets.synthetic_body_model(**kw)
    tbm = BodyModel.from_arrays(tassets.synthetic_body_model(**kw), "cpu")
    names = None if smplx_layout else [f"j{i}" for i in range(jbm.num_output_joints)]
    center = "head" if smplx_layout else "j5"
    B = 4
    pose = _pose(rng, B, 53)
    shape = rng.normal(size=(B, 10)).astype(np.float32)
    loc = rng.uniform(100, 500, size=(B, 2)).astype(np.float32)
    dist = rng.uniform(2, 10, size=(B, 1)).astype(np.float32)
    K = np.tile(np.array([[700, 0, 320], [0, 700, 300], [0, 0, 1]], np.float32), (B, 1, 1))
    expr = rng.normal(size=(B, 10)).astype(np.float32)
    args = (pose, shape, loc, dist, K)
    a = JLayer(jbm, person_center=center, joint_names=names)(
        *map(jnp.asarray, args), expression=jnp.asarray(expr))
    b = TLayer(tbm, person_center=center, joint_names=names)(
        *map(torch.from_numpy, args), expression=torch.from_numpy(expr))
    for k in ("v3d", "j3d", "transl", "transl_pelvis"):
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), atol=1e-5, err_msg=k)
    for k in ("j2d", "v2d"):
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), atol=2e-3, err_msg=k)

