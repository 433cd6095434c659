"""Batch collation: per-image person lists → padded [B, Kh] arrays
(``multihmr_tpu/data/collate.py``).

A copy of the JAX package's numpy code on the port's own
``io/preprocessing.py``; ``tests/test_torch_data.py`` holds it equal to the
original. Humans are zero-padded to the model's static capacity, with a
``gt_valid`` mask, so every batch has the same shape.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multihmr_tpu_torch.io.preprocessing import contain_size, resize_pad_numpy


def resize_with_K(
    img: np.ndarray, K: np.ndarray, img_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Contain-resize + centered zero-pad an image and update K accordingly
    (reference datasets/bedlam.py:208-236: scale focal/principal point by the
    resize ratio, shift the principal point by the pad offset)."""
    h, w = img.shape[:2]
    nw, nh = contain_size(w, h, img_size)
    ratio = nw / w  # == nh / h up to rounding
    out = resize_pad_numpy(img, img_size)
    K = K.copy().astype(np.float32)
    # Must match resize_pad_numpy's centering exactly: PIL ImageOps.pad uses
    # round(diff*0.5) (half-to-even), not floor — for pad diff ≡ 3 (mod 4)
    # the two differ by one pixel, which would put K's principal point one
    # row/column off from where the image actually landed.
    off_x, off_y = round((img_size - nw) * 0.5), round((img_size - nh) * 0.5)
    K[0, 0] *= ratio
    K[1, 1] *= ratio
    K[0, 2] = K[0, 2] * ratio + off_x
    K[1, 2] = K[1, 2] * ratio + off_y
    return out, K


def square_canvas_K(
    focal: np.ndarray, princpt: np.ndarray, size_wh: Sequence[int], img_size: int
) -> np.ndarray:
    """Intrinsics for an image contain-resized + zero-padded to the square
    ``img_size`` canvas: principal point scaled per-axis, focal re-derived
    through the LONG side (the contain ratio). One shared implementation for
    the formula every eval/train dataset needs — the reference writes it
    per-dataset (bedlam.py:209-213 directly; ehf.py:135-145 and
    threedpw.py:192-202 via an algebraically-identical FOV round-trip
    ``img_size / (2·tan(atan(max/(2f))))``)."""
    rw, rh = size_wh
    K = np.eye(3, dtype=np.float32)
    K[[0, 1], [2, 2]] = img_size * (np.asarray(princpt) / [rw, rh])
    K[[0, 1], [0, 1]] = img_size * np.asarray(focal) / max(rw, rh)
    return K


def collate_padded(
    samples: Sequence[Dict], max_people: int, person_keys: Optional[List[str]] = None
) -> Dict[str, np.ndarray]:
    """Stack per-image sample dicts into a padded batch.

    Each sample has image-level arrays (``image``, ``K``, ...) and a
    ``humans`` list of per-person dicts (``pose [53,3]``, ``shape``,
    ``transl``, ...). Persons beyond ``max_people`` are dropped (the
    reference pads to the batch max instead — a dynamic shape; here the
    capacity is static).
    """
    B = len(samples)
    batch: Dict[str, np.ndarray] = {}
    # image-level keys
    for key in samples[0]:
        if key == "humans":
            continue
        batch[key] = np.stack([np.asarray(s[key]) for s in samples])

    if person_keys is None:
        person_keys = sorted(
            {k for s in samples for h in s["humans"] for k in h}
        )
        if not person_keys:
            # All-empty batch (every person filtered, e.g. behind-camera):
            # still emit the standard GT keys with zero-filled shapes so the
            # train step never sees a missing key.
            _DEFAULTS = {"pose": (53, 3), "shape": (11,), "transl": (3,)}
            for key, shp in _DEFAULTS.items():
                batch[f"gt_{key}"] = np.zeros(
                    (B, max_people) + shp, np.float32
                )
            batch["gt_valid"] = np.zeros((B, max_people), np.float32)
            return batch
    valid = np.zeros((B, max_people), np.float32)
    for key in person_keys:
        proto = None
        for s in samples:
            for h in s["humans"]:
                if key in h:
                    proto = np.asarray(h[key])
                    break
            if proto is not None:
                break
        if proto is None:
            continue
        arr = np.zeros((B, max_people) + proto.shape, proto.dtype)
        for b, s in enumerate(samples):
            for i, h in enumerate(s["humans"][:max_people]):
                if key in h:
                    arr[b, i] = np.asarray(h[key])
        batch[f"gt_{key}"] = arr
    for b, s in enumerate(samples):
        valid[b, : min(len(s["humans"]), max_people)] = 1.0
    batch["gt_valid"] = valid
    return batch
