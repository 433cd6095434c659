"""Extra visualization views: side/BEV renders and rotating videos
(``multihmr_tpu/render/views.py``).

Equivalent of reference utils/render.py:407-448 (``render_side_views`` via a
lookAt camera) and demo.py:188-241 (``create_rotating_video``). numpy camera
math and the compiled rasterizer of :func:`render_meshes`; mp4 writing uses
imageio or cv2 when available, else writes PNG frames.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from multihmr_tpu_torch.render.render import render_meshes


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    """World→camera extrinsics (R, t) for a camera at ``eye`` looking at
    ``target`` (OpenCV convention: +z forward, +y down)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, np.float64)
    right = np.cross(fwd, upv)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], 0)  # rows
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


def render_view_from_angle(
    l_mesh: Sequence[np.ndarray],
    l_face: Sequence[np.ndarray],
    K: np.ndarray,
    width: int,
    height: int,
    angle_deg: float = 0.0,
    elevation_deg: float = 0.0,
    background: Optional[np.ndarray] = None,
):
    """Render the scene rotated ``angle_deg`` about the vertical axis through
    the scene centroid (0° = original camera). An empty scene renders the
    bare background (white), matching reference utils/render.py:420-423."""
    if len(l_mesh) == 0:
        return (
            background.copy()
            if background is not None
            else np.full((height, width, 3), 255, np.uint8)
        )
    all_pts = np.concatenate([np.asarray(m) for m in l_mesh], 0)
    center = all_pts.mean(0)
    dist = max(np.linalg.norm(all_pts - center, axis=-1).max() * 2.5, 1.0)
    a = np.radians(angle_deg)
    e = np.radians(elevation_deg)
    eye = center + dist * np.array(
        [np.sin(a) * np.cos(e), -np.sin(e), -np.cos(a) * np.cos(e)]
    )
    R, t = look_at(eye, center)
    meshes = [np.asarray(m) @ R.T + t for m in l_mesh]
    bg = (
        background
        if background is not None
        else np.full((height, width, 3), 255, np.uint8)
    )
    return render_meshes(bg, meshes, list(l_face), K)


def render_side_views(
    l_mesh, l_face, K, width: int, height: int, background=None
):
    """Front (re-render), 45° side, 90° side, bird's-eye — reference
    utils/render.py:407-448's view set."""
    views = {}
    for name, (angle, elev) in {
        "bis": (0, 0), "side45": (45, 0), "side90": (90, 0), "bev": (0, 80),
    }.items():
        views[name] = render_view_from_angle(
            l_mesh, l_face, K, width, height, angle, elev, background
        )
    return views


def create_rotating_video(
    l_mesh,
    l_face,
    K,
    width: int,
    height: int,
    fn: Optional[str] = None,
    n_frames: int = 20,
    angle_range: float = 60.0,
    fps: int = 10,
) -> List[np.ndarray]:
    """Frames sweeping the scene like the reference's rotating video
    (demo.py:188-241): centre → +angle_range (right) → centre →
    −angle_range (left) → centre about the vertical axis, then centre →
    +angle_range (top) → centre in elevation. Writes mp4 via imageio/cv2
    when ``fn`` given. Each directional leg has ``max(n_frames // 2, 2)``
    frames, so the full sweep is roughly ``3 * n_frames`` frames total."""
    leg = max(n_frames // 2, 2)
    out = np.linspace(0.0, angle_range, leg)
    back = out[::-1][1:]
    yaw = np.concatenate([out, back, -out[1:], -back])
    frames = [
        render_view_from_angle(l_mesh, l_face, K, width, height, a) for a in yaw
    ]
    frames += [
        render_view_from_angle(l_mesh, l_face, K, width, height, 0.0, e)
        for e in np.concatenate([out[1:], back])
    ]
    if fn is not None:
        _write_video(fn, frames, fps)
    return frames


def _write_video(fn: str, frames: List[np.ndarray], fps: int):
    try:
        import imageio

        imageio.mimwrite(fn, frames, fps=fps)
        return
    except Exception:
        pass
    try:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(fn, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in frames:
            vw.write(f[..., ::-1])
        vw.release()
        return
    except Exception:
        pass
    # last resort: PNG frames next to the target path
    base = os.path.splitext(fn)[0]
    from PIL import Image

    for i, f in enumerate(frames):
        Image.fromarray(f).save(f"{base}_frame{i:03d}.png")
