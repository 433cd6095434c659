"""Port parity of the geometry ops, detection and preprocessing.

The same numpy inputs (seeded) go through the JAX package's function and its
counterpart in ``multihmr_tpu_torch``, both in fp32 on the CPU.

Tolerances: element-wise fp32 ops agree to 1e-5 (a few ulp at the values
used: the two frameworks may fuse or order the same arithmetic differently).
Detection selections, masks and preprocessed uint8 images must be equal.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multihmr_tpu.ops import camera as jcam
from multihmr_tpu.ops import detection as jdet
from multihmr_tpu.ops import fourier as jfourier
from multihmr_tpu.ops import image as jimage
from multihmr_tpu.ops import rotations as jrot
from multihmr_tpu.io import preprocessing as jpre
from multihmr_tpu_torch.ops import camera as tcam
from multihmr_tpu_torch.ops import detection as tdet
from multihmr_tpu_torch.ops import fourier as tfourier
from multihmr_tpu_torch.ops import image as timage
from multihmr_tpu_torch.ops import rotations as trot
from multihmr_tpu_torch.io import preprocessing as tpre
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

ATOL = 1e-5  # element-wise fp32


def _both(fn_j, fn_t, *arrays):
    a = np.asarray(fn_j(*[jnp.asarray(x) for x in arrays]))
    b = fn_t(*[torch.from_numpy(np.array(x)) for x in arrays]).numpy()
    return a, b


def _intrinsics(rng, n):
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = rng.uniform(300, 900, n)
    K[:, 1, 1] = rng.uniform(300, 900, n)
    K[:, 0, 1] = rng.uniform(-2, 2, n)  # skew exercises the general inverse
    K[:, 0, 2] = rng.uniform(200, 500, n)
    K[:, 1, 2] = rng.uniform(200, 500, n)
    K[:, 2, 2] = 1.0
    return K


# ------------------------------------------------------------------ camera


def test_perspective_projection(rng):
    x = rng.normal(size=(3, 20, 3)).astype(np.float32)
    x[..., 2] = np.abs(x[..., 2]) + 1.0
    a, b = _both(jcam.perspective_projection, tcam.perspective_projection,
                 x, _intrinsics(rng, 3))
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-3)  # pixels ~1e3: ~1 ulp


def test_inv3x3_intrinsics(rng):
    K = _intrinsics(rng, 5)
    a, b = _both(jcam._inv3x3_intrinsics_general, tcam._inv3x3_intrinsics_general, K)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(b @ K, np.broadcast_to(np.eye(3), K.shape), atol=1e-5)


@pytest.mark.parametrize("with_distance", [True, False])
def test_inverse_perspective_projection(rng, with_distance):
    pts = rng.uniform(0, 640, size=(2, 30, 2)).astype(np.float32)
    K = _intrinsics(rng, 2)
    dist = rng.uniform(1, 20, size=(2, 30, 1)).astype(np.float32)
    d = dist if with_distance else None
    a = np.asarray(jcam.inverse_perspective_projection(
        jnp.asarray(pts), jnp.asarray(K), None if d is None else jnp.asarray(d)))
    b = tcam.inverse_perspective_projection(
        torch.from_numpy(pts), torch.from_numpy(K),
        None if d is None else torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=ATOL)


def test_focal_and_depth_decoding(rng):
    assert tcam.get_focal_length_from_fov(60, 896) == jcam.get_focal_length_from_fov(60, 896)
    y = rng.normal(size=(4, 3, 1)).astype(np.float32)
    f = rng.uniform(300, 900, size=(4, 1, 1)).astype(np.float32)
    a, b = _both(lambda y, f: jcam.undo_focal_length_normalization(y, f, 60, 896),
                 lambda y, f: tcam.undo_focal_length_normalization(y, f, 60, 896), y, f)
    np.testing.assert_allclose(b, a, rtol=1e-6)
    a, b = _both(jcam.undo_log_depth, tcam.undo_log_depth, y)
    np.testing.assert_allclose(b, a, rtol=1e-6)


# --------------------------------------------------------------- rotations


def test_rot6d_to_rotmat(rng):
    x = rng.normal(size=(4, 53, 6)).astype(np.float32)
    x[0, 0] = 0.0  # degenerate input: the clamps keep it finite
    a, b = _both(jrot.rot6d_to_rotmat, trot.rot6d_to_rotmat, x)
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=ATOL)


@pytest.mark.parametrize("scale", [1e-8, 1e-3, 1.0, 3.1])
def test_rotvec_to_rotmat(rng, scale):
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True) * scale).astype(np.float32)
    v[0] = 0.0
    a, b = _both(jrot.rotvec_to_rotmat, trot.rotvec_to_rotmat, v)
    np.testing.assert_allclose(b, a, atol=ATOL)


@pytest.mark.parametrize("angle", [0.0, 1e-4, 0.7, 2.5, np.pi - 1e-3])
def test_rotmat_to_rotvec(rng, angle):
    axis = rng.normal(size=(32, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    R = np.asarray(jrot.rotvec_to_rotmat(jnp.asarray((axis * angle).astype(np.float32))))
    a, b = _both(jrot.rotmat_to_unitquat, trot.rotmat_to_unitquat, R)
    np.testing.assert_allclose(b, a, atol=ATOL)
    a, b = _both(jrot.rotmat_to_rotvec, trot.rotmat_to_rotvec, R)
    # near pi the quaternion's w -> 0 amplifies fp32 rounding: 1e-4 there
    np.testing.assert_allclose(b, a, atol=ATOL if angle < 3 else 1e-4)


# ------------------------------------------------------- fourier and image


def test_fourier_ray_features(rng):
    rays = rng.normal(size=(2, 16, 3)).astype(np.float32)
    a, b = _both(jfourier.fourier_ray_features, tfourier.fourier_ray_features, rays)
    assert b.shape == (2, 16, 99)
    # sin/cos of arguments up to pi * 32 * |x| ~ 300 rad, whose fp32 ulp is
    # ~3e-5: the two libraries' argument rounding differs at that level
    np.testing.assert_allclose(b, a, atol=1e-4)


def test_token_grid_roundtrip(rng):
    tok = rng.normal(size=(2, 9, 5)).astype(np.float32)
    a, b = _both(lambda t: jimage.tokens_to_grid(t, 3), lambda t: timage.tokens_to_grid(t, 3), tok)
    np.testing.assert_array_equal(b, a)
    a, b = _both(jimage.grid_to_tokens, timage.grid_to_tokens, a)
    np.testing.assert_array_equal(b, tok)
    np.testing.assert_array_equal(timage.IMG_NORM_MEAN, jimage.IMG_NORM_MEAN)
    np.testing.assert_array_equal(timage.IMG_NORM_STD, jimage.IMG_NORM_STD)


# --------------------------------------------------------------- detection


def test_clamped_sigmoid(rng):
    x = (rng.normal(size=(3, 50)) * 20).astype(np.float32)
    a, b = _both(jdet.clamped_sigmoid, tdet.clamped_sigmoid, x)
    np.testing.assert_allclose(b, a, atol=1e-7)


@pytest.mark.parametrize("kernel", [1, 2, 3, 4, 5])
def test_nms_maxpool(rng, kernel):
    heat = rng.uniform(size=(2, 9, 11)).astype(np.float32)
    heat[0, 2:5, 3:6] = 0.9  # a plateau: equal neighbours all survive
    a, b = _both(lambda h: jdet.nms_maxpool(h, kernel), lambda h: tdet.nms_maxpool(h, kernel), heat)
    np.testing.assert_array_equal(b, a)


def _ties_heatmap(rng):
    # saturated sigmoid: many cells tie at exactly 1 - 1e-4
    logits = rng.normal(size=(3, 8, 8)).astype(np.float32) * 20
    logits[1] = 30.0  # every cell of image 1 ties
    return np.array(jdet.clamped_sigmoid(jnp.asarray(logits)))


@pytest.mark.parametrize("max_people", [4, 16, 80])
def test_topk_detect_ties(rng, max_people):
    scores = _ties_heatmap(rng)
    a = jdet.topk_detect(jnp.asarray(scores), 0.3, max_people)
    b = tdet.topk_detect(torch.from_numpy(scores), 0.3, max_people)
    for f in ("rows", "cols", "scores", "valid"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), err_msg=f)
    np.testing.assert_array_equal(b.count.numpy(), np.asarray(a.count))


def test_topk_detect_after_nms(rng):
    scores = _ties_heatmap(rng)
    for kernel in (2, 3):
        a = jdet.topk_detect(jdet.nms_maxpool(jnp.asarray(scores), kernel), 0.5, 16)
        b = tdet.topk_detect(tdet.nms_maxpool(torch.from_numpy(scores), kernel), 0.5, 16)
        for f in ("rows", "cols", "valid"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))


def test_gather_and_scatter_grid(rng):
    scores = rng.uniform(size=(2, 5, 5)).astype(np.float32)
    grid = rng.normal(size=(2, 5, 5, 7)).astype(np.float32)
    vals = rng.normal(size=(2, 6, 7)).astype(np.float32)
    a_det = jdet.topk_detect(jnp.asarray(scores), 0.6, 6)
    b_det = tdet.topk_detect(torch.from_numpy(scores), 0.6, 6)
    a = np.asarray(jdet.gather_grid(jnp.asarray(grid), a_det))
    b = tdet.gather_grid(torch.from_numpy(grid), b_det).numpy()
    np.testing.assert_array_equal(b, a)
    a = np.asarray(jdet.scatter_add_grid(jnp.asarray(grid), a_det, jnp.asarray(vals)))
    b = tdet.scatter_add_grid(torch.from_numpy(grid), b_det, torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(b, a, atol=ATOL)


# ----------------------------------------------------------- preprocessing


@pytest.mark.parametrize("wh", [(40, 30), (30, 41), (56, 56), (200, 90)])
def test_resize_pad_numpy(rng, wh):
    w, h = wh
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    assert tpre.contain_size(w, h, 56) == jpre.contain_size(w, h, 56)
    np.testing.assert_array_equal(tpre.resize_pad_numpy(img, 56), jpre.resize_pad_numpy(img, 56))


def test_preprocess_array(rng):
    img = rng.integers(0, 256, size=(33, 47, 3), dtype=np.uint8)
    a = jpre.preprocess_array(img, 56, fov=55.0)
    b = tpre.preprocess_array(img, 56, fov=55.0)
    np.testing.assert_array_equal(b.resized, np.asarray(a.resized))
    np.testing.assert_allclose(b.x, a.x, atol=1e-6)
    np.testing.assert_array_equal(b.K, a.K)
    np.testing.assert_array_equal(tpre.get_camera_parameters(896, 60),
                                  jpre.get_camera_parameters(896, 60))
