"""Rotation algebra (``multihmr_tpu/ops/rotations.py``).

6D → SO(3) Gram-Schmidt (the SMPL-X row layout and the Anny column-pair
layout), Rodrigues rotvec → rotmat, rotmat → rotvec through a branch-free
Shepperd quaternion, the homogeneous lift, and the scaled Procrustes
alignment of the PA metrics. The clamps that keep gradients finite at
theta → 0 are kept as the JAX package has them.
"""

from __future__ import annotations

import torch


def _normalize(v):
    # rsqrt(|v|^2 + eps): finite gradient at v == 0
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)


def rot6d_to_rotmat(x):
    """``(..., 6)`` as two interleaved row 3-vectors → ``(..., 3, 3)`` with
    columns ``b1, b2, b1 x b2``."""
    batch = x.shape[:-1]
    x = x.reshape(batch + (2, 3))
    a1, a2 = x[..., 0, :], x[..., 1, :]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rot6d_cols_to_rotmat(x):
    """``(..., 6)`` in the Anny column-pair layout ``[a1x a2x a1y a2y a1z a2z]``
    (the first two columns of R flattened row-major) → ``(..., 3, 3)``. The
    identity's 6d differs from :func:`rot6d_to_rotmat`'s row layout, so the
    wrong decoder silently breaks every identity-initialised joint."""
    batch = x.shape[:-1]
    x = x.reshape(batch + (3, 2))
    a1, a2 = x[..., 0], x[..., 1]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotvec_to_rotmat(rotvec):
    """Rodrigues: axis-angle ``(..., 3)`` → ``(..., 3, 3)``, with series
    fallbacks for sin(t)/t and (1 - cos t)/t^2 near zero."""
    theta2 = torch.sum(rotvec * rotvec, dim=-1)[..., None, None]
    theta2_safe = torch.clamp(theta2, min=1e-12)
    theta = torch.sqrt(theta2_safe)
    small = theta2 < 1e-12
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)

    x, y, z = rotvec[..., 0], rotvec[..., 1], rotvec[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    return eye + sinc * K + cosc * (K @ K)


def rotmat_to_unitquat(R):
    """Rotation matrix ``(..., 3, 3)`` → unit quaternion ``(..., 4)`` (x, y, z, w),
    choosing the best-conditioned of Shepperd's four candidates."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # candidate i (rows) in [w, x, y, z] order, scaled by 2 * pivot_i
    cand = torch.stack(
        [
            torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4 components)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)  # first maximum, as jnp.argmax
    idx = best[..., None, None].expand(best.shape + (1, 4))
    w, xq, yq, zq = torch.gather(cand, -2, idx)[..., 0, :].unbind(-1)
    q = torch.stack([xq, yq, zq, w], dim=-1)
    q = q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)
    # canonical sign: w >= 0
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def unitquat_to_rotvec(q):
    """Unit quaternion (x, y, z, w) → axis-angle ``(..., 3)``."""
    v = q[..., :3]
    w = q[..., 3]
    norm_v = torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)
    theta = 2.0 * torch.atan2(norm_v, w)
    small = norm_v < 1e-7
    scale = torch.where(small, 2.0 + theta * theta / 12.0,
                        theta / torch.clamp(norm_v, min=1e-24))
    return v * scale[..., None]


def rotmat_to_rotvec(R):
    """Rotation matrix → axis-angle."""
    return unitquat_to_rotvec(rotmat_to_unitquat(R))


def rotation_to_homogeneous(R):
    """``(..., 3, 3)`` rotations → ``(..., 4, 4)`` homogeneous matrices with
    zero translation."""
    h = torch.nn.functional.pad(R, (0, 1, 0, 1))
    h[..., 3, 3] = 1.0
    return h


def rigid_points_registration(x, y, compute_scaling: bool = True):
    """Scaled Procrustes alignment of point sets ``(..., N, 3)`` (Kabsch /
    Umeyama), ``roma.rigid_points_registration``'s function (reference
    train.py:391,426): R, s, t minimizing ``|| s * R @ x + t - y ||``.
    Returns (R ``(..., 3, 3)``, s ``(...)``, t ``(..., 3)``), or (R, t)
    without scaling.

    ``train/metrics.py::pa_pve`` is the JAX package's float64 numpy copy of
    the same algorithm, and stays so: it is a copied module, and runs once
    per matched person on the host."""
    mu_x = x.mean(dim=-2, keepdim=True)
    mu_y = y.mean(dim=-2, keepdim=True)
    xc, yc = x - mu_x, y - mu_y
    cov = torch.einsum("...ni,...nj->...ij", yc, xc)
    U, S, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vt)
    # Umeyama's d = ±1 only: det >= 0 counts as +1, so a degenerate
    # (coplanar) covariance still gives a proper rotation and keeps S[2]
    d = torch.where(det < 0, -1.0, 1.0).to(x.dtype)
    D = torch.eye(3, dtype=x.dtype, device=x.device).expand(cov.shape).clone()
    D[..., 2, 2] = d
    R = U @ D @ Vt
    t_rot = lambda m: torch.einsum("...ij,...j->...i", R, m)  # noqa: E731
    if compute_scaling:
        var_x = torch.sum(xc * xc, dim=(-1, -2))
        ones = torch.ones_like(d)
        s = torch.sum(S * torch.stack([ones, ones, d], -1), -1) / torch.clamp(var_x, min=1e-24)
        t = mu_y[..., 0, :] - s[..., None] * t_rot(mu_x[..., 0, :])
        return R, s, t
    return R, mu_y[..., 0, :] - t_rot(mu_x[..., 0, :])
