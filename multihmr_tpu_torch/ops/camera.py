"""Pinhole camera geometry (``multihmr_tpu/ops/camera.py``).

Plain fp32 torch; the JAX package runs these einsums at
``precision=HIGHEST``, so on CUDA the caller keeps TF32 off.
"""

from __future__ import annotations

import math

import torch


def perspective_projection(x, K):
    """``(..., N, 3)`` camera-space points, ``(..., 3, 3)`` K → ``(..., N, 2)`` pixels."""
    y = x / x[..., -1:]
    y = torch.einsum("...ij,...kj->...ki", K, y)
    return y[..., :2]


def _inv3x3_intrinsics_general(K):
    """Closed-form 3x3 inverse (adjugate over determinant), in fp32."""
    K = K.float()
    a, b, c = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2]
    d, e, f = K[..., 1, 0], K[..., 1, 1], K[..., 1, 2]
    g, h, i = K[..., 2, 0], K[..., 2, 1], K[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return inv / det[..., None, None]


def inverse_perspective_projection(points, K, distance):
    """``(..., N, 2)`` pixels → ``(..., N, 3)`` points ``K^-1 [u, v, 1] * distance``
    (unit-z rays when ``distance`` is None)."""
    ones = torch.ones_like(points[..., :1])
    homog = torch.cat([points, ones], dim=-1)
    Kinv = _inv3x3_intrinsics_general(K).to(points.dtype)
    rays = torch.einsum("...ij,...kj->...ki", Kinv, homog)
    if distance is None:
        return rays
    return rays * distance


def get_focal_length_from_fov(fov: float = 60, img_size: int = 512):
    """Focal length for a full-image field of view in degrees."""
    return img_size / (2 * math.tan(math.radians(fov) / 2))


def focal_length_normalization(x, f, fovn: int = 60, img_size: int = 448):
    """``E = (fn/f) * E'`` (E inverse depth)."""
    fn = get_focal_length_from_fov(fov=fovn, img_size=img_size)
    return x * (fn / f)


def undo_focal_length_normalization(y, f, fovn: int = 60, img_size: int = 448):
    """``E' = (f/fn) * E`` (inverse of the focal-length normalization)."""
    fn = get_focal_length_from_fov(fov=fovn, img_size=img_size)
    return y * (f / fn)


EPS_LOG = 1e-10


def log_depth(x, eps: float = EPS_LOG):
    """Depth → log depth."""
    return torch.log(x + eps)


def undo_log_depth(y, eps: float = EPS_LOG):
    """Log depth → depth."""
    return torch.exp(y) - eps
