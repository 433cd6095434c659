"""Mesh visualization on the host (``multihmr_tpu/render/render.py``).

Equivalent of reference utils/render.py:175-448 (pyrender overlay,
side-views, glb export) without pyrender or trimesh: a z-buffer rasterizer
with Lambertian shading, and a .glb writer against the glTF 2.0 binary
spec. Rendering is host work, off the card.

:func:`render_meshes` rasterizes with the compiled ``csrc/raster.cpp``
(``io/native.py::rasterize``), which raises if it cannot be built; its
numpy version :func:`_rasterize` gives the same pixels and stays as the
plain version (``plain=True``), for tests and for timing against it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import json
import struct

import numpy as np

from multihmr_tpu_torch.render.color import demo_color


def _rasterize(
    verts: np.ndarray,  # [V, 3] camera space
    faces: np.ndarray,  # [F, 3]
    K: np.ndarray,  # [3, 3]
    width: int,
    height: int,
    color=(0.65, 0.74, 0.86),
):
    """Z-buffer rasterizer with per-face Lambertian shading: the plain
    version of ``csrc/raster.cpp``.

    Returns (rgb float [H,W,3], depth [H,W] with +inf holes), bitwise equal
    to the compiled rasterizer's: every value is the same fp32 expression in
    the same order (the projection row by row, barycentrics times ``1/det``,
    the normal's length as ``sqrt(nx^2 + ny^2 + nz^2)``), and a pixel keeps
    the nearest fragment, the lowest face index among equal depths, as the
    compiled loop over faces does with its strict ``z < depth``. The JAX
    package's numpy version divides by ``det`` and lets the last of equal
    depths win, so it differs from its own native library by a few pixels
    per mesh; this one is written to agree with the compiled code exactly.
    """
    f32 = np.float32
    verts = np.asarray(verts, f32)
    faces = np.asarray(faces, np.int64)
    K = np.asarray(K, f32)
    X, Y, Z = verts[:, 0], verts[:, 1], verts[:, 2]
    zc = np.maximum(Z, f32(1e-9))
    vx = (K[0, 0] * X + K[0, 1] * Y + K[0, 2] * Z) / zc
    vy = (K[1, 0] * X + K[1, 1] * Y + K[1, 2] * Z) / zc
    tri2d = np.stack([vx[faces], vy[faces]], -1)  # [F, 3, 2]
    triz = Z[faces]  # [F, 3]
    # face normals for shading (camera space, double-sided)
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    nx = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
    ny = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
    nz = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    nn = np.sqrt(nx * nx + ny * ny + nz * nz)
    with np.errstate(divide="ignore", invalid="ignore"):
        cos = np.where(nn > f32(1e-12), np.abs(nz) / nn, f32(1.0))
    shade = f32(0.35) + f32(0.65) * cos

    color = np.asarray(color, f32)
    depth = np.full(height * width, np.inf, f32)
    image = np.zeros((height * width, 3), f32)
    winner = np.full(height * width, np.iinfo(np.int64).max, np.int64)  # face index

    a, b, c = tri2d[:, 0], tri2d[:, 1], tri2d[:, 2]
    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1])
    with np.errstate(divide="ignore"):
        inv_det = f32(1.0) / det
    # cull: behind the camera, degenerate, or outside the frame
    xmin = np.floor(tri2d[..., 0].min(1)).astype(np.int64)
    xmax = np.ceil(tri2d[..., 0].max(1)).astype(np.int64)
    ymin = np.floor(tri2d[..., 1].min(1)).astype(np.int64)
    ymax = np.ceil(tri2d[..., 1].max(1)).astype(np.int64)
    ok = ((triz > f32(1e-6)).all(1) & (np.abs(det) >= f32(1e-12))
          & (xmax >= 0) & (xmin < width) & (ymax >= 0) & (ymin < height))

    def merge(flat, z, fid):
        """Keep per pixel the nearest fragment, the lowest face among ties."""
        if len(flat) == 0:
            return
        order = np.lexsort((fid, z, flat))
        flat, z, fid = flat[order], z[order], fid[order]
        first = np.ones(len(flat), bool)
        first[1:] = flat[1:] != flat[:-1]
        flat, z, fid = flat[first], z[first], fid[first]
        better = (z < depth[flat]) | ((z == depth[flat]) & (fid < winner[flat]))
        flat, z, fid = flat[better], z[better], fid[better]
        depth[flat] = z
        winner[flat] = fid
        image[flat] = shade[fid, None] * color

    def rasterize_faces(fids, win):
        """Each face in a ``win`` x ``win`` pixel window from its bbox's corner."""
        if len(fids) == 0:
            return
        fa, fb, fc, inv = a[fids], b[fids], c[fids], inv_det[fids]
        dx = np.arange(win, dtype=f32)
        px = xmin[fids].astype(f32)[:, None] + dx[None]  # [F, W]
        py = ymin[fids].astype(f32)[:, None] + dx[None]
        xs = px[:, None, :] + f32(0.5)  # [F, 1, W]
        ys = py[:, :, None] + f32(0.5)  # [F, W, 1]
        ax, ay = fa[:, None, None, 0], fa[:, None, None, 1]
        bx, by = fb[:, None, None, 0], fb[:, None, None, 1]
        cx, cy = fc[:, None, None, 0], fc[:, None, None, 1]
        l1 = ((xs - ax) * (cy - ay) - (cx - ax) * (ys - ay)) * inv[:, None, None]
        l2 = ((bx - ax) * (ys - ay) - (xs - ax) * (by - ay)) * inv[:, None, None]
        l0 = f32(1.0) - l1 - l2
        z = (l0 * triz[fids, 0][:, None, None] + l1 * triz[fids, 1][:, None, None]
             + l2 * triz[fids, 2][:, None, None])
        ix = np.broadcast_to(px[:, None, :], z.shape).astype(np.int64)
        iy = np.broadcast_to(py[:, :, None], z.shape).astype(np.int64)
        valid = ((l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                 & (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height))
        fid = np.broadcast_to(fids[:, None, None], z.shape)
        merge((iy * width + ix)[valid], z[valid], fid[valid])

    # windows of 12, 48 and 128 pixels (human-mesh triangles project small),
    # chunked for memory; a face larger than that gets a window of its own
    covered = np.zeros_like(ok)
    for win, chunk in ((12, 1 << 14), (48, 2048), (128, 256)):
        tier = ok & ~covered & (xmax - xmin < win) & (ymax - ymin < win)
        ids = np.nonzero(tier)[0]
        for s in range(0, len(ids), chunk):
            rasterize_faces(ids[s:s + chunk], win)
        covered |= tier
    for f in np.nonzero(ok & ~covered)[0]:
        x0, y0 = max(xmin[f], 0), max(ymin[f], 0)
        win = int(max(min(xmax[f], width - 1) - x0, min(ymax[f], height - 1) - y0)) + 1
        xmin[f], ymin[f] = x0, y0
        rasterize_faces(np.array([f]), win)
    return image.reshape(height, width, 3), depth.reshape(height, width)


def _soften_mask(fg: np.ndarray) -> np.ndarray:
    """Feather the foreground mask's edges (reference utils/render.py:301-310):
    ``fg ← max(0, 2·mean3×3(fg) − 1) · fg`` — interior stays 1, boundary
    pixels whose 3×3 neighborhood is less than half-covered fade out, so the
    overlay blends into the background instead of a hard staircase edge."""
    H, W = fg.shape
    p = np.pad(fg, 1)
    s = np.zeros_like(fg)
    for dy in range(3):
        for dx in range(3):
            s += p[dy : dy + H, dx : dx + W]
    return np.clip(s * (2.0 / 9.0) - 1.0, 0.0, None) * fg


def render_meshes(
    img: np.ndarray,  # [H, W, 3] uint8 background
    l_mesh: Sequence[np.ndarray],
    l_face: Sequence[np.ndarray],
    cam_param: np.ndarray,  # K [3,3]
    color=None,
    alpha: float = 0.75,
    plain: bool = False,
):
    """Overlay meshes onto an image (reference utils/render.py:175-315).

    Returns the blended uint8 array. The compiled rasterizer draws every
    mesh into one shared z-buffer; ``plain=True`` rasterizes each mesh with
    the numpy :func:`_rasterize` and merges their depths, with the same
    result.
    """
    H, W = img.shape[:2]
    out = img.astype(np.float32) / 255.0
    colors = color if color is not None else demo_color

    acc_img = np.zeros((H, W, 3), np.float32)
    acc_depth = np.full((H, W), np.inf, np.float32)
    if not plain:
        from multihmr_tpu_torch.io import native

        # shared z-buffer across meshes: occlusion handled natively
        for i, (verts, faces) in enumerate(zip(l_mesh, l_face)):
            native.rasterize(
                np.asarray(verts, np.float32), np.asarray(faces, np.int32),
                np.asarray(cam_param, np.float32), W, H,
                color=colors[i % len(colors)], rgb=acc_img, depth=acc_depth,
            )
    else:
        for i, (verts, faces) in enumerate(zip(l_mesh, l_face)):
            rgb, depth = _rasterize(
                np.asarray(verts, np.float32),
                np.asarray(faces, np.int64),
                np.asarray(cam_param, np.float32),
                W, H,
                color=colors[i % len(colors)],
            )
            closer = depth < acc_depth
            acc_depth[closer] = depth[closer]
            acc_img[closer] = rgb[closer]
    fg = _soften_mask(np.isfinite(acc_depth).astype(np.float32))[..., None]
    out = fg * (alpha * acc_img + (1 - alpha) * out) + (1 - fg) * out
    return (out * 255).astype(np.uint8)


def overlay_human_meshes(humans, faces, K, img, unique_color=False, alpha=0.75):
    """Reference demo.py:128-158 equivalent: overlay each detected person's
    mesh. ``humans`` is the list-of-dicts from ``extract_persons``."""
    l_mesh = [np.asarray(h["v3d"]) for h in humans]
    l_face = [np.asarray(faces)] * len(l_mesh)
    colors = [demo_color[0]] * len(l_mesh) if unique_color else demo_color
    arr = render_meshes(np.asarray(img), l_mesh, l_face, np.asarray(K)[0], colors, alpha)
    return arr, colors[: len(l_mesh)]


def get_bbox(points2d: np.ndarray, factor: float = 1.35):
    """2D keypoints → expanded bbox (reference utils/render.py:384-405)."""
    x1, y1 = points2d.min(0)
    x2, y2 = points2d.max(0)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    sx, sy = (x2 - x1) * factor / 2, (y2 - y1) * factor / 2
    return np.array([cx - sx, cy - sy, cx + sx, cy + sy])


def print_distance_on_image(arr, humans, colors):
    """Annotate each person with its camera distance
    (reference utils/render.py:365-382) — cv2-free fallback draws nothing if
    cv2 is unavailable."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return arr
    arr = arr.copy()
    for h, c in zip(humans, colors):
        d = float(np.asarray(h["transl_pelvis"]).reshape(-1)[2])
        loc = np.asarray(h["loc"]).astype(int)
        cv2.putText(
            arr, f"{d:.2f}m", (int(loc[0]), int(loc[1])),
            cv2.FONT_HERSHEY_SIMPLEX, 0.7, tuple(int(255 * x) for x in c), 2,
        )
    return arr


def export_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    """Dependency-free Wavefront OBJ export."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in np.asarray(faces) + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def create_glb_scene(
    l_mesh: Sequence[np.ndarray],
    l_face: Sequence[np.ndarray],
    path: Optional[str] = None,
    img=None,
    focal: float = 600.0,
    colors: Optional[Sequence] = None,
    camera_marker: bool = True,
) -> bytes:
    """Minimal binary glTF 2.0 (.glb) scene export of the predicted meshes
    (reference utils/render.py:62-173 exports via trimesh; this writes the
    container directly — loadable by any glTF viewer).

    Parity with the reference scene: optional per-mesh colors, the input
    ``img`` as a textured plane placed at the camera's focal geometry
    (screen_width 0.3, distance focal·0.3/img_width — utils/render.py:94-97),
    and a red camera-frustum wireframe at the optical center (:136-165;
    rendered as glTF LINES instead of the reference's pseudo-edge triangle
    trick — same marker, native primitive).
    """
    bufs, buffer_views, accessors, meshes, nodes = bytearray(), [], [], [], []
    materials, textures, images_json, samplers = [], [], [], []
    FLIP = np.array([1, -1, -1], np.float32)  # camera (+Y down) → glTF (+Y up)

    def add_view(data: bytes, target=None):
        off = len(bufs)
        bufs.extend(data)
        while len(bufs) % 4:
            bufs.append(0)
        view = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if target:
            view["target"] = target
        buffer_views.append(view)
        return len(buffer_views) - 1

    def add_accessor(view, ctype, count, atype, vmin=None, vmax=None):
        acc = {"bufferView": view, "componentType": ctype, "count": count,
               "type": atype}
        if vmin is not None:
            acc["min"], acc["max"] = vmin, vmax
        accessors.append(acc)
        return len(accessors) - 1

    def add_positions(v: np.ndarray):
        view = add_view(v.tobytes(), 34962)
        return add_accessor(
            view, 5126, len(v), "VEC3", v.min(0).tolist(), v.max(0).tolist()
        )

    for i, (verts, faces) in enumerate(zip(l_mesh, l_face)):
        v = np.asarray(verts, np.float32) * FLIP
        f = np.asarray(faces, np.uint32)
        pos = add_positions(v)
        idx = add_accessor(add_view(f.tobytes(), 34963), 5125, f.size, "SCALAR")
        prim = {"attributes": {"POSITION": pos}, "indices": idx}
        if colors is not None:
            # per-mesh colors may arrive as a list/tuple of RGB triples OR a
            # [N, 3] numpy array (palette math output); a single RGB triple
            # (any container, ndim == 1) applies to every mesh. float64 so
            # Python-float inputs round-trip exactly into the JSON.
            carr = np.asarray(colors, np.float64)
            c = carr[i] if carr.ndim == 2 else carr
            materials.append(
                {
                    "pbrMetallicRoughness": {
                        "baseColorFactor": [float(c[0]), float(c[1]), float(c[2]), 1.0],
                        "metallicFactor": 0.0,
                        "roughnessFactor": 0.5,
                    }
                }
            )
            prim["material"] = len(materials) - 1
        meshes.append({"primitives": [prim]})
        nodes.append({"mesh": len(meshes) - 1})

    # ---- textured image plane (reference utils/render.py:93-134) ----
    plane_hx = plane_hy = dist = None
    if img is not None:
        arr = np.asarray(img)
        ih, iw = arr.shape[:2]
        # reference scale: screen_width 0.3, distance focal*0.3/width
        # (utils/render.py:94-96); aspect kept upright (width:height = iw:ih)
        screen_width = 0.3
        dist = focal * screen_width / iw  # plane distance from optical center
        plane_hx = screen_width / 2.0
        plane_hy = plane_hx * (ih / iw)
        # corners in OpenCV camera space (x right, y down, z forward)
        corners = np.array(
            [
                [-plane_hx, -plane_hy, dist],
                [plane_hx, -plane_hy, dist],
                [plane_hx, plane_hy, dist],
                [-plane_hx, plane_hy, dist],
            ],
            np.float32,
        ) * FLIP
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        tris = np.array([[0, 1, 2], [0, 2, 3], [2, 1, 0], [3, 2, 0]], np.uint32)

        import io as _io

        from PIL import Image as _Image

        pil = img if hasattr(img, "save") else _Image.fromarray(arr.astype(np.uint8))
        png = _io.BytesIO()
        pil.save(png, format="PNG")
        img_view = add_view(png.getvalue())
        images_json.append({"bufferView": img_view, "mimeType": "image/png"})
        samplers.append({"magFilter": 9729, "minFilter": 9729})
        textures.append({"source": len(images_json) - 1, "sampler": 0})
        materials.append(
            {
                "pbrMetallicRoughness": {
                    "baseColorTexture": {"index": len(textures) - 1},
                    "metallicFactor": 0.0,
                    "roughnessFactor": 1.0,
                },
                "doubleSided": True,
            }
        )
        pos = add_positions(corners)
        uv_acc = add_accessor(add_view(uv.tobytes(), 34962), 5126, 4, "VEC2")
        idx = add_accessor(add_view(tris.tobytes(), 34963), 5125, tris.size, "SCALAR")
        meshes.append(
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": pos, "TEXCOORD_0": uv_acc},
                        "indices": idx,
                        "material": len(materials) - 1,
                    }
                ]
            }
        )
        nodes.append({"mesh": len(meshes) - 1})

    # ---- camera-frustum wireframe (reference utils/render.py:136-165) ----
    if camera_marker:
        hx = plane_hx if plane_hx is not None else 0.15
        hy = plane_hy if plane_hy is not None else 0.15
        d = dist if dist is not None else 0.2
        corners = np.array(
            [
                [-hx, -hy, d], [hx, -hy, d], [hx, hy, d], [-hx, hy, d],
            ],
            np.float32,
        ) * FLIP
        apex = np.zeros((1, 3), np.float32)
        v = np.concatenate([apex, corners])
        # 4 apex→corner edges + base loop, as glTF LINES (mode 1)
        lines = np.array(
            [0, 1, 0, 2, 0, 3, 0, 4, 1, 2, 2, 3, 3, 4, 4, 1], np.uint32
        )
        materials.append(
            {
                "pbrMetallicRoughness": {
                    "baseColorFactor": [1.0, 0.0, 0.0, 1.0],
                    "metallicFactor": 0.0,
                },
            }
        )
        pos = add_positions(v)
        idx = add_accessor(add_view(lines.tobytes(), 34963), 5125, lines.size, "SCALAR")
        meshes.append(
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": pos},
                        "indices": idx,
                        "mode": 1,
                        "material": len(materials) - 1,
                    }
                ]
            }
        )
        nodes.append({"mesh": len(meshes) - 1})

    gltf = {
        "asset": {"version": "2.0", "generator": "multihmr_tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(bufs)}],
    }
    if materials:
        gltf["materials"] = materials
    if textures:
        gltf["textures"] = textures
        gltf["images"] = images_json
        gltf["samplers"] = samplers
    js = json.dumps(gltf).encode()
    while len(js) % 4:
        js += b" "
    total = 12 + 8 + len(js) + 8 + len(bufs)
    out = (
        struct.pack("<III", 0x46546C67, 2, total)
        + struct.pack("<II", len(js), 0x4E4F534A) + js
        + struct.pack("<II", len(bufs), 0x004E4942) + bytes(bufs)
    )
    if path:
        with open(path, "wb") as fh:
            fh.write(out)
    return out
