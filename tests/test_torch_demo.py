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
