"""The port's dataset CLI (``multihmr_tpu_torch/cli/data.py``) against the JAX
package's (``multihmr_tpu/cli/data.py``) on the CPU, on the synthetic
BEDLAM and EHF trees of tests/test_cli_train.py (EHF's images at its real
1600 x 1200, which its K assumes): ``create_jpeg`` writes the
same files bitwise, ``create_annots`` the same annotation caches,
``dataloader`` walks the set, and ``visualize --device cpu`` poses the same
GT bodies (vertices within 1e-5 m of the JAX command's, measured 9.5e-7:
both run fp32 LBS, summing in other orders) and draws them into a PNG whose
overlay differs from the JAX one on at most 0.5 % of the pixels either
covers (measured 0 of 1,613 and 2,144; the two packages' rasterizers can
differ on large triangles, ROADMAP Queue 3, and the synthetic body's random
faces are large ones)."""

import os
import pickle

import numpy as np
import pytest

import multihmr_tpu.cli.data as jdata
import multihmr_tpu.render as jrender
import multihmr_tpu_torch.cli.data as tdata
import multihmr_tpu_torch.render as trender
from tests.test_cli_train import _write_bedlam, _write_ehf
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

VERT_TOL = 1e-5  # m
PIXEL_SHARE = 0.005  # of the pixels either overlay covers


@pytest.fixture
def trees(tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.default_rng(0)
    _write_bedlam(tmp_path / "data" / "BEDLAM", rng, split="validation")
    _write_ehf(tmp_path / "data" / "EHF", rng)
    for i in range(2):  # the real size: EHF's K places the GT meshes in it
        Image.fromarray(np.tile(np.linspace(0, 255, 1600, dtype=np.uint8)[None, :, None],
                                (1200, 1, 3))).save(tmp_path / "data" / "EHF" / f"{i:02d}_img.png")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SMPLX_DIR", raising=False)
    return tmp_path


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("target", [32, None])
def test_create_jpeg_matches_jax(tmp_path, rng, target):
    """tests/test_datasets.py::test_create_jpeg_walks_and_resizes on both
    packages: the same files, byte for byte."""
    from PIL import Image

    for pkg in ("jax", "port"):
        d = tmp_path / pkg / "seq" / "png"
        d.mkdir(parents=True)
        r = np.random.default_rng(1)
        Image.fromarray(r.integers(0, 255, size=(60, 120, 3), dtype=np.uint8)).save(d / "wide.png")
        Image.fromarray(r.integers(0, 255, size=(120, 60, 3), dtype=np.uint8)).save(
            tmp_path / pkg / "tall.png")
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(d / ".hidden.png")
        (d / "notes.txt").write_text("not an image")
    assert jdata.create_jpeg(str(tmp_path / "jax"), target_size=target, log_freq=0) == 2
    assert tdata.create_jpeg(str(tmp_path / "port"), target_size=target, log_freq=0) == 2
    files = _tree_files(tmp_path / "jax")
    assert files == _tree_files(tmp_path / "port")
    jpgs = [f for f in files if f.endswith(".jpg")]
    assert len(jpgs) == 2 and not any(".hidden" in f for f in jpgs)
    for f in jpgs:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    if target == 32:
        assert Image.open(tmp_path / "port" / "seq" / "png" / "wide_32.jpg").size == (32, 16)


def test_create_jpeg_cli(tmp_path, capsys):
    from PIL import Image

    Image.fromarray(np.zeros((30, 40, 3), np.uint8)).save(tmp_path / "a.png")
    tdata.main(["create_jpeg", "--root_dir", str(tmp_path), "--target_size", "20"])
    assert "converted 1 png(s)" in capsys.readouterr().out
    assert Image.open(tmp_path / "a_20.jpg").size == (20, 15)


def _same(a, b, path=""):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("dataset,cache", [("bedlam", "bedlam_validation.pkl"),
                                           ("ehf", "ehf_test.pkl")])
def test_create_annots_matches_jax(trees, capsys, monkeypatch, dataset, cache):
    args = ["create_annots", "--dataset", dataset, "--img_size", "56"]
    monkeypatch.setattr("sys.argv", ["data"] + args)
    jdata.main()
    with open(trees / "data" / cache, "rb") as f:
        want = pickle.load(f)
    os.remove(trees / "data" / cache)
    tdata.main(args)
    assert "built annotations" in capsys.readouterr().out
    with open(trees / "data" / cache, "rb") as f:
        got = pickle.load(f)
    _same(got, want)


@pytest.mark.parametrize("dataset", ["bedlam", "ehf"])
def test_dataloader(trees, capsys, dataset):
    tdata.main(["dataloader", "--dataset", dataset, "--img_size", "56", "--n", "4"])
    out = capsys.readouterr().out
    assert "2 samples in" in out and "img/s" in out
    assert out.startswith("[0/2] ")


def _spy(monkeypatch, module, seen):
    real = module.render_meshes

    def spy(img, l_mesh, *a, **kw):
        seen.append([np.asarray(m, np.float64) for m in l_mesh])
        return real(img, l_mesh, *a, **kw)

    monkeypatch.setattr(module, "render_meshes", spy)


@pytest.mark.parametrize("dataset,n_humans", [("bedlam", 2), ("ehf", 1)])
def test_visualize_matches_jax(trees, capsys, monkeypatch, dataset, n_humans):
    from PIL import Image

    seen_j, seen_t = [], []
    _spy(monkeypatch, jrender, seen_j)
    _spy(monkeypatch, trender, seen_t)
    args = ["visualize", "--dataset", dataset, "--img_size", "64", "--index", "1"]
    monkeypatch.setattr("sys.argv", ["data"] + args)
    jdata.main()
    want = np.asarray(Image.open(f"{dataset}_vis_1.png"))
    os.remove(f"{dataset}_vis_1.png")
    tdata.main(args + ["--device", "cpu"])
    assert f"({n_humans} humans)" in capsys.readouterr().out.splitlines()[-1]
    got = np.asarray(Image.open(f"{dataset}_vis_1.png"))
    (vj,), (vt,) = seen_j, seen_t
    assert len(vt) == len(vj) == n_humans
    for a, b in zip(vt, vj):
        assert a.shape == b.shape == (10475, 3)
        assert np.abs(a - b).max() <= VERT_TOL
    assert got.shape == want.shape == (64, 128, 3)
    np.testing.assert_array_equal(got[:, :64], want[:, :64])  # the image itself
    img = got[:, :64]
    covered = ((got[:, 64:] != img).any(-1) | (want[:, 64:] != img).any(-1)).sum()
    assert covered > 0
    assert (got[:, 64:] != want[:, 64:]).any(-1).sum() <= PIXEL_SHARE * covered


def test_visualize_gt_meshes_device_arg(trees):
    """``gt_meshes`` poses BEDLAM's GT on the device it is given: the CPU
    result is the reference the card's is held to (chip_smoke phase 20)."""
    import torch

    from multihmr_tpu_torch.factory import load_body_model

    ds = tdata.get_dataset("bedlam", 56)
    _, annot = ds[0]
    bm = load_body_model("cpu", 11)
    meshes = tdata.gt_meshes(annot["humans"], bm, torch.device("cpu"))
    assert len(meshes) == 2 and all(m.shape == (10475, 3) and np.isfinite(m).all()
                                    for m in meshes)
    assert tdata.gt_meshes([], bm, "cpu") == []
