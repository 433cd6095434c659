"""The port's renderer (``multihmr_tpu_torch/render``) and its compiled
rasterizer (``csrc/raster.cpp`` through ``io/native.py``) against the JAX
package's ``render`` on the same meshes, and the cases of
tests/test_render.py on the port.

The compiled rasterizer and the port's numpy ``_rasterize`` (its plain
version) compute every value with the same fp32 expression in the same
order and break depth ties the same way, so they are held bitwise equal,
also on a mesh of large overlapping random triangles where ties and edge
pixels abound. The JAX package renders with its own native library, built
with ``-march=native`` (FMA contraction), or with its numpy version (which
divides by ``det`` and lets the last of equal depths win); on that mesh its
two disagree with each other by a few pixels, and the port differs from
them by as few. On smooth meshes all four are bitwise equal, and that is
held here: ``render_meshes``, side views and rotating-video frames; the
``.glb`` bytes and ``.obj`` text are equal on any mesh.
"""

import io
import json
import struct

import numpy as np
import pytest

import multihmr_tpu.render as J
from multihmr_tpu_torch import render as T
from multihmr_tpu_torch.io import native
from multihmr_tpu_torch.render.render import _rasterize, _soften_mask
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)


def make_triangle_scene():
    # one big triangle facing the camera at z=2
    verts = np.array([[-0.5, -0.5, 2.0], [0.5, -0.5, 2.0], [0.0, 0.5, 2.0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int64)
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    return verts, faces, K


def ellipsoid(n_lat=16, n_lon=32):
    """A closed UV ellipsoid of small triangles, person-like in extent."""
    th = np.linspace(0, np.pi, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    v = np.stack([np.sin(th)[:, None] * np.cos(ph)[None],
                  np.cos(th)[:, None] * np.ones_like(ph)[None],
                  np.sin(th)[:, None] * np.sin(ph)[None]], -1).reshape(-1, 3)
    f = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            f += [[a, a + n_lon, b], [b, a + n_lon, b + n_lon]]
    return (v * np.array([0.25, 0.8, 0.2])).astype(np.float32), np.array(f, np.int64)


def smooth_scene(n=8, seed=0):
    """n overlapping ellipsoids at 2.5-8 m in a 320 x 240 image."""
    rng = np.random.default_rng(seed)
    v, f = ellipsoid()
    meshes = [(v * rng.uniform(0.7, 1.3) + np.array(
        [rng.uniform(-1.2, 1.2), rng.uniform(-0.6, 0.6), rng.uniform(2.5, 8)])).astype(np.float32)
        for _ in range(n)]
    K = np.array([[250.0, 0, 160], [0, 250.0, 120], [0, 0, 1]], np.float32)
    img = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    return meshes, [f] * n, K, img


def random_triangle_scene(n=3, seed=1):
    """Meshes of 600 random triangles over 200 vertices, spanning the
    image: large overlapping faces, many ties and edge pixels."""
    rng = np.random.default_rng(seed)
    faces = rng.integers(0, 200, (600, 3))
    meshes = [(rng.normal(size=(200, 3)) * [0.8, 0.6, 0.3] + [0, 0, 3 + i]).astype(np.float32)
              for i in range(n)]
    K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]], np.float32)
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    return meshes, [faces] * n, K, img


# ---- the compiled rasterizer against its plain version and the JAX package

@pytest.mark.parametrize("scene", [smooth_scene, random_triangle_scene])
def test_compiled_rasterizer_matches_plain_bitwise(scene):
    meshes, faces, K, img = scene()
    H, W = img.shape[:2]
    for i, (v, f) in enumerate(zip(meshes, faces)):
        rgb_c, d_c = native.rasterize(v, f, K, W, H, color=T.demo_color[i])
        rgb_p, d_p = _rasterize(v, f, K, W, H, color=T.demo_color[i])
        assert np.isfinite(d_c).sum() > 0
        np.testing.assert_array_equal(d_c, d_p)
        np.testing.assert_array_equal(rgb_c, rgb_p)
    np.testing.assert_array_equal(T.render_meshes(img, meshes, faces, K),
                                  T.render_meshes(img, meshes, faces, K, plain=True))


def test_render_matches_jax_bitwise():
    meshes, faces, K, img = smooth_scene()
    got = T.render_meshes(img, meshes, faces, K, alpha=0.6)
    assert (got != img).any(-1).sum() > 5000
    np.testing.assert_array_equal(got, J.render_meshes(img, meshes, faces, K, alpha=0.6))
    from multihmr_tpu.render.render import _rasterize as j_rasterize

    for v, f in zip(meshes[:2], faces):  # the JAX package's numpy version too
        rgb_j, d_j = j_rasterize(v, f, K, img.shape[1], img.shape[0])
        rgb_t, d_t = _rasterize(v, f, K, img.shape[1], img.shape[0])
        np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(d_j))
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5)  # /det against *(1/det)
        np.testing.assert_array_equal(rgb_t, rgb_j)


def test_render_against_jax_on_random_triangles():
    """Where the JAX package's own two rasterizers disagree (FMA, division
    by det, ties), the port covers the same pixels and differs from each by
    no more than they differ from each other, plus a pixel."""
    import multihmr_tpu.io.native as jnative

    meshes, faces, K, img = random_triangle_scene()
    got = T.render_meshes(img, meshes, faces, K)
    j_native = J.render_meshes(img, meshes, faces, K)
    avail = jnative.native_available
    try:
        jnative.native_available = lambda: False
        j_numpy = J.render_meshes(img, meshes, faces, K)
    finally:
        jnative.native_available = avail
    covered = (got != img).any(-1)
    assert covered.sum() > 5000
    np.testing.assert_array_equal(covered, (j_native != img).any(-1))
    diff = lambda a, b: int((a != b).any(-1).sum())  # noqa: E731
    spread = diff(j_native, j_numpy)
    assert diff(got, j_native) <= spread + 1 and diff(got, j_numpy) <= spread + 1
    assert diff(got, j_native) <= 0.005 * covered.sum()


def test_rasterizer_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback to numpy: a build that fails raises from the
    renderer."""
    verts, faces, K = make_triangle_scene()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("--no-such-flag",))
    native.build.cache_clear()
    native._load.cache_clear()
    try:
        assert not native.native_available()
        with pytest.raises(RuntimeError, match="raster.cpp failed"):
            T.render_meshes(np.zeros((64, 64, 3), np.uint8), [verts], [faces], K)
    finally:
        native.build.cache_clear()
        native._load.cache_clear()


# ---- views, video frames, .glb and .obj against the JAX package

def test_side_views_and_video_frames_match_jax(tmp_path):
    meshes, faces, K, _ = smooth_scene(n=3)
    got = T.render_side_views(meshes, faces, K, 96, 72)
    want = J.render_side_views(meshes, faces, K, 96, 72)
    assert set(got) == set(want) == {"bis", "side45", "side90", "bev"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    a = T.create_rotating_video(meshes, faces, K, 48, 36, n_frames=4)
    b = J.create_rotating_video(meshes, faces, K, 48, 36, n_frames=4)
    assert len(a) == len(b) == 6 * 2 - 5
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)


def test_video_writer_png_last_resort(tmp_path, monkeypatch):
    """Without imageio and cv2 the frames go to PNG files beside the path."""
    import sys

    from PIL import Image

    from multihmr_tpu_torch.render.views import _write_video

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    frames = [np.full((8, 10, 3), i, np.uint8) for i in range(3)]
    _write_video(str(tmp_path / "v.mp4"), frames, fps=5)
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / f"v_frame{i:03d}.png")), frames[i])


@pytest.mark.parametrize("scene", [make_triangle_scene, smooth_scene])
def test_glb_and_obj_match_jax(tmp_path, scene):
    if scene is make_triangle_scene:
        v, f, _ = scene()
        meshes, faces = [v], [f]
    else:
        meshes, faces, _, _ = scene(n=2)
    img = np.zeros((60, 80, 3), np.uint8)
    img[:, :, 0] = 200
    for kw in ({}, {"img": img, "focal": 600.0, "colors": [(0.2, 0.4, 0.6)] * len(meshes)},
               {"colors": np.array([[0.1, 0.2, 0.3]] * len(meshes)), "camera_marker": False}):
        assert T.create_glb_scene(meshes, faces, **kw) == J.create_glb_scene(meshes, faces, **kw)
    T.export_obj(str(tmp_path / "t.obj"), meshes[0], faces[0])
    J.export_obj(str(tmp_path / "j.obj"), meshes[0], faces[0])
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()


def test_overlay_and_distance_match_jax():
    meshes, faces, K, img = smooth_scene(n=3)
    humans = [{"v3d": m, "transl_pelvis": m.mean(0)[None], "loc": np.array([40.0 + 50 * i, 60])}
              for i, m in enumerate(meshes)]
    for unique in (False, True):
        a, ca = T.overlay_human_meshes(humans, faces[0], K[None], img, unique_color=unique,
                                       alpha=0.5)
        b, cb = J.overlay_human_meshes(humans, faces[0], K[None], img, unique_color=unique,
                                       alpha=0.5)
        np.testing.assert_array_equal(a, b)
        assert ca == cb
        np.testing.assert_array_equal(T.print_distance_on_image(a, humans, ca),
                                      J.print_distance_on_image(b, humans, cb))
    assert T.demo_color == J.demo_color


# ---- the cases of tests/test_render.py, on the port

@pytest.mark.parametrize("plain", [False, True])
def test_rasterizer_covers_expected_pixels(plain):
    verts, faces, K = make_triangle_scene()
    img = np.zeros((64, 64, 3), np.uint8)
    out = T.render_meshes(img, [verts], [faces], K, alpha=1.0, plain=plain)
    # triangle centroid projects to (32, 32-ish) and must be colored
    assert out[32, 32].sum() > 0
    # far corners stay background
    assert out[0, 0].sum() == 0 and out[63, 63].sum() == 0


@pytest.mark.parametrize("plain", [False, True])
def test_rasterizer_depth_ordering(plain):
    # near triangle must occlude far triangle
    near = np.array([[-0.4, -0.4, 1.0], [0.4, -0.4, 1.0], [0.0, 0.4, 1.0]], np.float32)
    far = near.copy()
    far[:, 2] = 3.0
    faces = np.array([[0, 1, 2]], np.int64)
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    img = np.zeros((64, 64, 3), np.uint8)
    out_nf = T.render_meshes(img, [near, far], [faces, faces], K,
                             color=[(1.0, 0, 0), (0, 1.0, 0)], alpha=1.0, plain=plain)
    out_fn = T.render_meshes(img, [far, near], [faces, faces], K,
                             color=[(0, 1.0, 0), (1.0, 0, 0)], alpha=1.0, plain=plain)
    # center pixel red (near wins) regardless of draw order
    assert out_nf[32, 32, 0] > out_nf[32, 32, 1]
    assert out_fn[32, 32, 0] > out_fn[32, 32, 1]


def test_soften_mask_reference_semantics():
    """fg ← max(0, 2·mean3×3(fg) − 1)·fg (reference utils/render.py:301-310):
    interior stays 1, a straight edge feathers to 1/3, an isolated pixel
    (2/9 coverage) vanishes."""
    half = np.zeros((8, 8), np.float32)
    half[:, 4:] = 1.0  # vertical half-plane
    s = _soften_mask(half)
    assert s[4, 6] == 1.0  # interior: 9/9 → 2·1−1 = 1
    np.testing.assert_allclose(s[4, 4], 1.0 / 3.0, atol=1e-6)  # 6/9 → 1/3
    assert s[4, 3] == 0.0  # background side stays 0 (multiplied by fg)

    lone = np.zeros((5, 5), np.float32)
    lone[2, 2] = 1.0
    assert _soften_mask(lone).max() == 0.0  # 1/9 coverage → clamped away


def test_render_meshes_edges_are_feathered():
    """Overlay boundary pixels blend part-way instead of a hard cut."""
    verts, faces, K = make_triangle_scene()
    img = np.full((64, 64, 3), 200, np.uint8)
    out = T.render_meshes(img, [verts], [faces], K, alpha=1.0, color=[(0.0, 0.0, 0.0)])
    inside, bg = out[32, 32], out[0, 0]
    assert tuple(bg) == (200, 200, 200)
    assert inside.sum() < 30  # fully covered → mesh color
    mids = (out[..., 0] > 40) & (out[..., 0] < 180)
    assert mids.any()


def test_glb_export_valid_container(tmp_path):
    verts, faces, _ = make_triangle_scene()
    data = T.create_glb_scene([verts], [faces], str(tmp_path / "s.glb"))
    assert (tmp_path / "s.glb").read_bytes() == data
    magic, version, length = struct.unpack("<III", data[:12])
    assert magic == 0x46546C67 and version == 2 and length == len(data)
    jlen, jtype = struct.unpack("<II", data[12:20])
    assert jtype == 0x4E4F534A
    gltf = json.loads(data[20: 20 + jlen])
    assert gltf["asset"]["version"] == "2.0"
    # human mesh + the always-on camera-frustum marker
    assert len(gltf["meshes"]) == 2


def test_obj_export(tmp_path):
    verts, faces, _ = make_triangle_scene()
    p = tmp_path / "m.obj"
    T.export_obj(str(p), verts, faces)
    lines = p.read_text().splitlines()
    assert sum(1 for ln in lines if ln.startswith("v ")) == 3
    assert sum(1 for ln in lines if ln.startswith("f ")) == 1


def test_side_views_and_video():
    verts, faces, K = make_triangle_scene()
    views = T.render_side_views([verts], [faces], K, 64, 64)
    assert set(views) == {"bis", "side45", "side90", "bev"}
    for v in views.values():
        assert v.shape == (64, 64, 3)
    frames = T.create_rotating_video([verts], [faces], K, 48, 48, n_frames=4)
    assert len(frames) == 6 * 2 - 5
    for fr in frames:
        assert fr.shape == (48, 48, 3)
    # empty scene: white frames, not a crash (reference utils/render.py:420)
    blank = T.render_view_from_angle([], [], K, 32, 24, 30.0)
    assert blank.shape == (24, 32, 3) and (blank == 255).all()


def test_get_bbox():
    pts = np.array([[10.0, 20], [30, 60]])
    np.testing.assert_allclose(T.get_bbox(pts, factor=1.0), [10, 20, 30, 60])
    np.testing.assert_array_equal(T.get_bbox(pts * 1.5), J.get_bbox(pts * 1.5))


def test_glb_scene_image_plane_and_frustum(tmp_path):
    """Textured image plane + red camera-frustum wireframe + per-mesh colors."""
    from PIL import Image

    verts, faces, _ = make_triangle_scene()
    img = np.zeros((60, 80, 3), np.uint8)
    img[:, :, 0] = 200
    data = T.create_glb_scene([verts], [faces], str(tmp_path / "s.glb"),
                              img=img, focal=600.0, colors=[(0.2, 0.4, 0.6)])
    jlen, _ = struct.unpack("<II", data[12:20])
    gltf = json.loads(data[20: 20 + jlen])
    assert len(gltf["meshes"]) == 3 and len(gltf["nodes"]) == 3
    assert len(gltf["textures"]) == 1 and len(gltf["images"]) == 1
    plane = gltf["meshes"][1]["primitives"][0]
    assert "TEXCOORD_0" in plane["attributes"]
    assert "baseColorTexture" in gltf["materials"][plane["material"]]["pbrMetallicRoughness"]
    frustum = gltf["meshes"][2]["primitives"][0]
    assert frustum["mode"] == 1
    red = gltf["materials"][frustum["material"]]
    assert red["pbrMetallicRoughness"]["baseColorFactor"][:3] == [1.0, 0.0, 0.0]
    body_mat = gltf["materials"][gltf["meshes"][0]["primitives"][0]["material"]]
    assert body_mat["pbrMetallicRoughness"]["baseColorFactor"][:3] == [0.2, 0.4, 0.6]
    img_view = gltf["bufferViews"][gltf["images"][0]["bufferView"]]
    bin_off = 20 + jlen + 8
    png = data[bin_off + img_view["byteOffset"]:][: img_view["byteLength"]]
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), img)
