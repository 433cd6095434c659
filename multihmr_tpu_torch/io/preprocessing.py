"""Host-side image preprocessing (``multihmr_tpu/io/preprocessing.py``).

Aspect-preserving resize into the square, centred zero pad, ImageNet
normalization (NHWC), and K from the field of view. PIL is optional: without
it the resize runs on the numpy path, which matches PIL's BICUBIC resample
within 1/255 per channel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from multihmr_tpu_torch.ops.camera import get_focal_length_from_fov
from multihmr_tpu_torch.ops.image import IMG_NORM_MEAN, IMG_NORM_STD

try:  # PIL is optional
    from PIL import Image, ImageOps

    _HAS_PIL = True
except ImportError:
    _HAS_PIL = False


def contain_size(w: int, h: int, target: int) -> Tuple[int, int]:
    """``ImageOps.contain``: fit inside (target, target), aspect kept,
    Python's half-to-even round as PIL."""
    if w >= h:
        return target, max(1, int(round(h * target / w)))
    return max(1, int(round(w * target / h))), target


def _bicubic_kernel(x: np.ndarray) -> np.ndarray:
    # Catmull-Rom (a = -0.5), PIL's BICUBIC
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


def _resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``[out, in]`` weights of PIL's separable resample: the support widens
    with the downscale factor, weights normalized per output pixel."""
    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = 2.0 * fs
    W = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        w = _bicubic_kernel((xs - center + 0.5) / fs)
        s = w.sum()
        W[xx, xmin:xmax] = w / s if s != 0.0 else w
    return W


def _clip8_round(v: np.ndarray) -> np.ndarray:
    # PIL's fixed-point rounding: floor(v + 0.5), clipped to uint8
    return np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8)


def resize_pad_numpy(img: np.ndarray, img_size: int) -> np.ndarray:
    """BICUBIC contain + centred zero pad of an HWC uint8 image, in numpy,
    rounding to uint8 between the horizontal and vertical passes like PIL."""
    h, w = img.shape[:2]
    nw, nh = contain_size(w, h, img_size)
    tmp = _clip8_round(
        np.einsum("ow,hwc->hoc", _resample_matrix(w, nw), img.astype(np.float64)))
    resized = _clip8_round(
        np.einsum("oh,hwc->owc", _resample_matrix(h, nh), tmp.astype(np.float64)))
    out = np.zeros((img_size, img_size, img.shape[2]), img.dtype)
    # ImageOps.pad centres with round(diff * 0.5), half-to-even
    oy, ox = round((img_size - nh) * 0.5), round((img_size - nw) * 0.5)
    out[oy:oy + nh, ox:ox + nw] = resized
    return out


def normalize_nhwc(img: np.ndarray) -> np.ndarray:
    """uint8 HWC → float32 HWC ImageNet-normalized."""
    x = img.astype(np.float32) / 255.0
    return (x - IMG_NORM_MEAN) / IMG_NORM_STD


def get_camera_parameters(img_size: int, fov: float = 60) -> np.ndarray:
    """K ``[1, 3, 3]`` for the padded square image, principal point at its
    centre."""
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = get_focal_length_from_fov(fov=fov, img_size=img_size)
    K[0, 2] = K[1, 2] = img_size // 2
    return K[None]


class PreprocessedImage(NamedTuple):
    x: np.ndarray  # [S, S, 3] normalized float32
    K: np.ndarray  # [3, 3]
    original: object  # the unresized image: PIL (its .size is (W, H)), or the array without PIL
    resized: np.ndarray  # [S, S, 3] uint8 after contain + pad


def preprocess_array(img_rgb: np.ndarray, img_size: int, fov: float = 60.0) -> PreprocessedImage:
    """uint8 HWC RGB → normalized square image, its K, and the original for
    rendering at full size (:func:`rescale_K_to_original`)."""
    img_rgb = np.asarray(img_rgb)
    if _HAS_PIL:
        original = Image.fromarray(img_rgb).convert("RGB")
        resized = np.asarray(ImageOps.pad(ImageOps.contain(original, (img_size, img_size)),
                                          size=(img_size, img_size)))
    else:
        original = img_rgb
        resized = resize_pad_numpy(img_rgb, img_size)
    return PreprocessedImage(normalize_nhwc(resized),
                             get_camera_parameters(img_size, fov=fov)[0], original, resized)


def open_image(path: str, img_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """An image file → normalized NHWC float32 ``[1, S, S, 3]`` and the
    unresized RGB array (the JAX ``open_image``; reference demo.py:27-51)."""
    if _HAS_PIL:
        img = np.asarray(Image.open(path).convert("RGB"))
    else:  # pragma: no cover
        img = np.asarray(__import__("imageio").imread(path))[..., :3]
    return preprocess_array(img, img_size).x[None], img


def rescale_K_to_original(K: np.ndarray, orig_w: int, orig_h: int, img_size: int):
    """K ``[1, 3, 3]`` of the padded square → K for rendering at the
    original resolution (reference demo.py:341-344)."""
    K = K.copy()
    ratio = max(orig_w, orig_h) / img_size
    K[0, 0, 2] = orig_w / 2.0
    K[0, 1, 2] = orig_h / 2.0
    K[0, 0, 0] *= ratio
    K[0, 1, 1] *= ratio
    return K
