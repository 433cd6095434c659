"""The port's demo CLI (``multihmr_tpu_torch/cli/demo.py``) on the CPU: the
one-stage-ahead pipeline of tests/test_demo_cli.py (image *i+1*'s forward
is enqueued before image *i*'s host render), and the files the JAX demo
writes, with every overlay flag, on a tiny model; the overlay panel equals
the JAX package's renderer on the same meshes."""

import json
import os

import numpy as np
import pytest
import torch

from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.models.multihmr import Readback, persons_from_host
from tests.test_checkpoint import TinyConfig
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)


class _FakeBody:
    faces = torch.zeros((4, 3), dtype=torch.int64)
    v_template = torch.zeros((12, 3))
    num_vertices = 12


class _FakeCfg:
    img_size = 64
    max_people = 2


class _FakeNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = torch.nn.Linear(2, 2)


class _FakeModel:
    cfg = _FakeCfg()
    body_model = _FakeBody()

    def __init__(self, events):
        self._events = events
        self.net = _FakeNet()

    def forward(self, x, K, det_thresh, nms_kernel_size):
        self._events.append("dispatch")
        return {"v3d": torch.zeros((1, 2, 12, 3))}

    def start_persons(self, out):
        return Readback({"valid": torch.zeros((1, 2))}, persons_from_host)


def _run_demo(tmp_path, monkeypatch, n_images):
    from PIL import Image

    import multihmr_tpu_torch.factory as factory
    import multihmr_tpu_torch.render as render
    from multihmr_tpu_torch.cli import demo

    src = tmp_path / "in"
    src.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n_images):
        Image.fromarray(rng.uniform(0, 255, (40, 48, 3)).astype(np.uint8)).save(src / f"im{i}.jpg")
    events = []
    model = _FakeModel(events)
    monkeypatch.setattr(factory, "build_model", lambda *a, **kw: model)
    real_overlay = render.overlay_human_meshes

    def overlay_spy(*a, **kw):
        events.append("process")
        return real_overlay(*a, **kw)

    monkeypatch.setattr(render, "overlay_human_meshes", overlay_spy)
    out_dir = tmp_path / "out"
    import io as _io
    from contextlib import redirect_stdout

    buf = _io.StringIO()
    with redirect_stdout(buf):
        demo.main(["--img_folder", str(src), "--out_folder", str(out_dir),
                   "--model_name", "stub", "--device", "cpu"])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return events, json.loads(lines[-1]), out_dir


def test_demo_pipeline_dispatches_one_stage_ahead(tmp_path, monkeypatch):
    events, summary, out_dir = _run_demo(tmp_path, monkeypatch, 3)
    # serial would be d p d p d p; the pipeline must run d d p d p p
    assert events == ["dispatch", "dispatch", "process", "dispatch", "process", "process"]
    assert summary["n_images"] == 3
    assert summary["img_per_s"] > 0 and summary["wall_s"] > 0
    assert summary["p50_wait_ms"] >= 0 and summary["p50_image_ms"] > 0
    assert len(list(out_dir.glob("*.png"))) == 3


@pytest.mark.parametrize("n", [0, 1])
def test_demo_pipeline_degenerate_counts(tmp_path, monkeypatch, n):
    events, summary, out_dir = _run_demo(tmp_path, monkeypatch, n)
    assert events == ["dispatch", "process"] * n
    assert summary["n_images"] == n
    if n == 0:
        assert summary["p50_wait_ms"] is None and summary["img_per_s"] is None
    assert len(list(out_dir.glob("*.png"))) == n


def test_demo_writes_the_jax_demos_files(tmp_path, monkeypatch):
    from PIL import Image

    import multihmr_tpu_torch.factory as factory
    from multihmr_tpu.io.preprocessing import get_camera_parameters, rescale_K_to_original
    from multihmr_tpu.render import overlay_human_meshes, print_distance_on_image
    from multihmr_tpu_torch.cli import demo
    from multihmr_tpu_torch.io import preprocessing as tpre

    cfg = TinyConfig(img_size=56, max_people=3, person_center="head", compute_dtype="float32")
    monkeypatch.setattr(factory, "named_config", lambda name: cfg)
    small = synthetic_body_model(num_joints=55, num_vertices=64, num_extra=21, num_lmk=51)
    monkeypatch.setattr(factory, "smplx_like_synthetic", lambda nb: small)
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(3)
    imgs = {f"im{i}.png": rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
            for i, hw in enumerate([(40, 48), (50, 30)])}
    for name, img in imgs.items():
        Image.fromarray(img).save(src / name)
    demo.main(["--img_folder", str(src), "--out_folder", str(out), "--model_name",
               "multiHMR_672_S", "--device", "cpu", "--det_thresh", "0.0", "--save_mesh", "1",
               "--extra_views", "1", "--distance", "1", "--unique_color", "1",
               "--save_rotating_video", "1", "--alpha", "0.6", "--fov", "50"])
    faces = np.asarray(small["faces"])
    for name, img in imgs.items():
        save_fn = out / f"{name}_multiHMR_672_S.png"
        strip = np.asarray(Image.open(save_fn))
        h, w = img.shape[:2]
        assert strip.shape == (h, 3 * w, 3)  # image | overlay | 45-degree view
        np.testing.assert_array_equal(strip[:, :w], img)
        meshes = np.load(out / f"{name}_multiHMR_672_S.png.npy")
        assert meshes.shape == (3, 64, 3)
        assert (out / f"{name}_multiHMR_672_S.png.glb").read_bytes()[:4] == b"glTF"
        for j in range(3):
            assert (out / f"{name}_multiHMR_672_S.png.person{j}.obj").is_file()
        video = str(save_fn).replace(".png", "_rotating.mp4")  # the JAX demo's name
        assert os.path.isfile(video) or os.path.isfile(video[:-4] + "_frame000.png")
        rec = json.loads((out / f"{name}_multiHMR_672_S.json").read_text())
        assert len(rec["persons"]) == 3
        # the overlay panel: the JAX package's renderer and K on the same meshes
        K_full = rescale_K_to_original(get_camera_parameters(56, fov=50), w, h, 56)
        np.testing.assert_array_equal(
            tpre.rescale_K_to_original(tpre.get_camera_parameters(56, fov=50), w, h, 56), K_full)
        humans = [{"v3d": m, "transl_pelvis": np.asarray(p["transl_pelvis"]),
                   "loc": np.asarray(p["loc"])} for m, p in zip(meshes, rec["persons"])]
        arr, colors = overlay_human_meshes(humans, faces, K_full, img, unique_color=True,
                                           alpha=0.6)
        arr = print_distance_on_image(arr, humans, colors)
        panel = strip[:, w:2 * w]
        covered = (arr != img).any(-1)
        assert covered.sum() > 0
        np.testing.assert_array_equal((panel != img).any(-1), covered)
        assert (panel != arr).any(-1).sum() <= 0.01 * covered.sum()


def _spy_overlay(monkeypatch, events):
    """Record a "process" event where the demo draws an image's overlay."""
    import multihmr_tpu_torch.render as render

    real_overlay = render.overlay_human_meshes

    def overlay_spy(*a, **kw):
        events.append("process")
        return real_overlay(*a, **kw)

    monkeypatch.setattr(render, "overlay_human_meshes", overlay_spy)


def _folder(src, specs):
    """Images by name: (h, w) for a PNG or JPEG by the name's extension, or
    "bmp" for a BMP under a .png name (the native decoder refuses it, PIL
    reads it)."""
    from PIL import Image

    src.mkdir(exist_ok=True)
    rng = np.random.default_rng(4)
    for name, spec in specs.items():
        img = Image.fromarray(rng.integers(0, 256, size=(36, 44, 3), dtype=np.uint8))
        if spec == "bmp":
            img.save(src / name, format="BMP")
        else:
            Image.fromarray(rng.integers(0, 256, size=spec + (3,), dtype=np.uint8)).save(src / name)


def test_demo_native_loader(tmp_path, monkeypatch, capsys):
    """The JAX demo's native loader (multihmr_tpu/cli/demo.py:85-107): the
    summary names it; the one-stage pipeline runs as before; each image's
    forward takes its preprocess_file tensor in sorted order (a large first
    image arrives after the small ones behind it and they wait for it); a
    file the loader cannot decode goes through PIL, as the JAX demo's
    load_image does."""
    from PIL import Image

    import multihmr_tpu_torch.factory as factory
    from multihmr_tpu_torch.cli import demo
    from multihmr_tpu_torch.io import native
    from multihmr_tpu_torch.io.preprocessing import preprocess_array

    src, out = tmp_path / "in", tmp_path / "out"
    _folder(src, {"a_big.jpg": (1600, 1200), "b.png": (40, 48), "c.png": "bmp",
                  "d.jpg": (30, 50), "e.png": (64, 20)})
    names = sorted(os.listdir(src))
    events, calls = [], []
    model = _FakeModel(events)
    monkeypatch.setattr(factory, "build_model", lambda *a, **kw: model)
    _spy_overlay(monkeypatch, events)
    start = demo.start_image

    def spy(model, img, *a, x=None, **kw):
        calls.append((img, x))
        return start(model, img, *a, x=x, **kw)

    monkeypatch.setattr(demo, "start_image", spy)
    demo.main(["--img_folder", str(src), "--out_folder", str(out), "--model_name", "stub",
               "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["loader"] == "native" and summary["n_images"] == 5
    assert events == ["dispatch", "dispatch"] + ["process", "dispatch"] * 3 + ["process"] * 2
    assert len(calls) == len(names)
    for name, (img, x) in zip(names, calls):
        path = str(src / name)
        if name == "c.png":  # refused by the loader: decoded by PIL, preprocessed as before
            assert x is None
            np.testing.assert_array_equal(img, np.asarray(Image.open(path).convert("RGB")))
            with pytest.raises(IOError):
                native.preprocess_file(path, 64)
            assert preprocess_array(img, 64).x.shape == (64, 64, 3)
        else:
            assert img is None
            np.testing.assert_array_equal(x, native.preprocess_file(path, 64), err_msg=name)
    # the overlay draws on the original image
    for name in names:
        strip = np.asarray(Image.open(out / f"{name}_stub.png"))
        orig = np.asarray(Image.open(src / name).convert("RGB"))
        np.testing.assert_array_equal(strip[:, :orig.shape[1]], orig)


def test_in_order_holds_early_arrivals():
    """The loader's completion order → the demo's sorted order; failures
    (-(i + 1)) become None."""
    from multihmr_tpu_torch.cli.demo import in_order

    a = {i: np.full((2, 2, 3), i, np.float32) for i in range(5)}

    class Loader:
        def __len__(self):
            return 5

        def __iter__(self):
            yield from [(3, a[3]), (0, a[0]), (-3, np.zeros((2, 2, 3), np.float32)), (1, a[1]),
                        (4, a[4])]

    got = list(in_order(Loader()))
    assert [None if g is None else int(g[0, 0, 0]) for g in got] == [0, 1, None, 3, 4]


def test_demo_pil_without_the_image_library(tmp_path, monkeypatch, capsys):
    """Where the image library does not build, the demo says so on stderr
    and runs the PIL path: the summary names it, the outputs are those of
    the decoded images."""
    import multihmr_tpu_torch.factory as factory
    from multihmr_tpu_torch.cli import demo
    from multihmr_tpu_torch.io import native

    def no_library(*a, **kw):
        raise RuntimeError("building image_io.cpp failed (1): jpeglib.h: No such file")

    src = tmp_path / "in"
    _folder(src, {"a.jpg": (40, 48), "b.png": (30, 30)})
    events, calls = [], []
    model = _FakeModel(events)
    monkeypatch.setattr(factory, "build_model", lambda *a, **kw: model)
    monkeypatch.setattr(native, "NativeImageLoader", no_library)
    _spy_overlay(monkeypatch, events)
    start = demo.start_image
    monkeypatch.setattr(demo, "start_image",
                        lambda m, img, *a, x=None, **kw: calls.append(x) or start(m, img, *a, **kw))
    demo.main(["--img_folder", str(src), "--out_folder", str(tmp_path / "out"),
               "--model_name", "stub", "--device", "cpu"])
    captured = capsys.readouterr()
    assert json.loads(captured.out.splitlines()[-1])["loader"] == "pil"
    assert "decoding with PIL" in captured.err and "jpeglib.h" in captured.err
    assert calls == [None, None] and events == ["dispatch", "dispatch", "process", "process"]


def test_demo_unreadable_file_raises(tmp_path, monkeypatch):
    """A file neither the loader nor PIL can read raises PIL's error, as the
    JAX demo's open_image does."""
    from PIL import UnidentifiedImageError

    import multihmr_tpu_torch.factory as factory
    from multihmr_tpu_torch.cli import demo

    src = tmp_path / "in"
    src.mkdir()
    (src / "x.jpg").write_bytes(b"not an image at all")
    monkeypatch.setattr(factory, "build_model", lambda *a, **kw: _FakeModel([]))
    with pytest.raises(UnidentifiedImageError):
        demo.main(["--img_folder", str(src), "--out_folder", str(tmp_path / "out"),
                   "--model_name", "stub", "--device", "cpu"])
