"""The port's copies of pure-Python training helpers equal the JAX package's.

``data/collate.py`` (on the port's own ``io/preprocessing.py``),
``data/prefetch.py``, ``data/ply.py``, ``data/bedlam.py``, ``data/ehf.py``,
``train/metrics.py`` and ``utils/logging.py`` are copies; each is held to its
original on the same seeded inputs, exactly.
"""

import json
import pickle

import numpy as np
import pytest

from multihmr_tpu.data import bedlam as jbed
from multihmr_tpu.data import collate as jcol
from multihmr_tpu.data import ehf as jehf
from multihmr_tpu.data import ply as jply
from multihmr_tpu.data import prefetch as jpre
from multihmr_tpu.train import metrics as jmet
from multihmr_tpu.utils import logging as jlog
from multihmr_tpu_torch.data import bedlam as tbed
from multihmr_tpu_torch.data import collate as tcol
from multihmr_tpu_torch.data import ehf as tehf
from multihmr_tpu_torch.data import ply as tply
from multihmr_tpu_torch.data import prefetch as tpre
from multihmr_tpu_torch.train import metrics as tmet
from multihmr_tpu_torch.utils import logging as tlog
from tests.test_cli_train import _write_bedlam
from tests.test_datasets import write_ply_ascii, write_ply_binary
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)


def _sample(rng, n_humans, extra=False):
    humans = [{"pose": rng.normal(size=(53, 3)).astype(np.float32),
               "shape": rng.normal(size=(11,)).astype(np.float32),
               "transl": rng.normal(size=3).astype(np.float32)} for _ in range(n_humans)]
    if extra and humans:
        humans[0]["bbox"] = np.arange(4, dtype=np.float32)
    return {"image": rng.normal(size=(8, 8, 3)).astype(np.float32),
            "K": np.eye(3, dtype=np.float32), "humans": humans}


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("counts", [(2, 0, 5), (0, 0), (3,)])
def test_collate_padded_equal(counts):
    rng = np.random.default_rng(0)
    samples = [_sample(rng, n, extra=True) for n in counts]
    _assert_same(tcol.collate_padded(samples, 4), jcol.collate_padded(samples, 4))


@pytest.mark.parametrize("hw", [(100, 200), (114, 128), (77, 40)])
def test_resize_with_K_equal(hw):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, size=hw + (3,), dtype=np.uint8)
    K = np.array([[500.0, 0, hw[1] / 2], [0, 500, hw[0] / 2], [0, 0, 1]], np.float32)
    a_img, a_K = tcol.resize_with_K(img, K, 64)
    b_img, b_K = jcol.resize_with_K(img, K, 64)
    np.testing.assert_array_equal(a_img, b_img)
    np.testing.assert_array_equal(a_K, b_K)


def test_square_canvas_K_equal():
    args = (np.array([1000.0, 990.0]), np.array([640.0, 360.0]), (1280, 720), 896)
    np.testing.assert_array_equal(tcol.square_canvas_K(*args), jcol.square_canvas_K(*args))


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_bounded_parallel_map_equal(workers):
    fn = lambda i: i * i  # noqa: E731
    got = list(tpre.bounded_parallel_map(fn, range(20), num_workers=workers))
    assert got == list(jpre.bounded_parallel_map(fn, range(20), num_workers=workers))

    def boom(i):
        if i == 3:
            raise ValueError("item 3")
        return i

    with pytest.raises(ValueError, match="item 3"):
        list(tpre.bounded_parallel_map(boom, range(6), num_workers=workers))


def test_average_meter_equal():
    a, b = tmet.AverageMeter("loss", ":.3f"), jmet.AverageMeter("loss", ":.3f")
    for val, n in ((1.0, 1), (2.5, 3), (0.25, 2)):
        a.update(val, n)
        b.update(val, n)
        assert (a.val, a.sum, a.count, a.avg, str(a)) == (b.val, b.sum, b.count, b.avg, str(b))
    a.reset()
    assert (a.val, a.avg, a.sum, a.count) == (0, 0, 0, 0)


def _assert_tree_equal(a, b, path="root"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("writer", [write_ply_ascii, write_ply_binary])
def test_ply_reader_equal(tmp_path, writer):
    verts = np.random.default_rng(2).normal(size=(33, 3)).astype(np.float32)
    writer(tmp_path / "m.ply", verts)
    np.testing.assert_array_equal(tply.read_ply_vertices(str(tmp_path / "m.ply")),
                                  jply.read_ply_vertices(str(tmp_path / "m.ply")))


def test_flip_smplx_params_equal():
    rng = np.random.default_rng(3)
    hum = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("smplx_transl", (3,)), ("smplx_root_pose", (1, 3)), ("smplx_jaw_pose", (1, 3)),
        ("smplx_body_pose", (21, 3)), ("smplx_left_hand_pose", (15, 3)),
        ("smplx_right_hand_pose", (15, 3)), ("smplx_leye_pose", (1, 3)),
        ("smplx_reye_pose", (1, 3)))}
    _assert_tree_equal(tbed.flip_smplx_params(hum), jbed.flip_smplx_params(hum))
    assert tbed.FLIP_PAIRS == jbed.FLIP_PAIRS


@pytest.mark.parametrize("split,training", [("training", True), ("validation", False)])
def test_bedlam_equal(tmp_path, split, training):
    _write_bedlam(tmp_path / "BEDLAM", np.random.default_rng(4), split=split)
    kw = dict(split=split, training=training, img_size=56, root_dir=str(tmp_path / "BEDLAM"),
              n_iter=3 if training else None)
    a = tbed.BEDLAM(annotations_dir=str(tmp_path / "ta"), seed=7, **kw)
    b = jbed.BEDLAM(annotations_dir=str(tmp_path / "ja"), seed=7, **kw)
    _assert_tree_equal(a.annots, b.annots)
    # the pickles each wrote load back equal too
    with open(tmp_path / "ta" / f"bedlam_{split}.pkl", "rb") as f:
        _assert_tree_equal(pickle.load(f), b.annots)
    assert len(a) == len(b) and repr(a) == repr(b)
    for i in range(len(a)):
        _assert_tree_equal(a[i], b[i], f"item {i}")


def test_ehf_equal(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    root = tmp_path / "EHF"
    root.mkdir()
    for i in range(2):
        write_ply_binary(root / f"{i:02d}_align.ply", rng.normal(size=(40, 3)).astype(np.float32))
        Image.fromarray(rng.integers(0, 255, size=(90, 120, 3), dtype=np.uint8)).save(
            root / f"{i:02d}_img.png")
    a = tehf.EHF(img_size=56, root_dir=str(root), annotations_dir=str(tmp_path / "ta"))
    b = jehf.EHF(img_size=56, root_dir=str(root), annotations_dir=str(tmp_path / "ja"))
    _assert_tree_equal(a.annots, b.annots)
    assert len(a) == len(b) == 2
    for i in range(2):
        _assert_tree_equal(a[i], b[i], f"item {i}")
    for name in ("EHF_CAM_ROTVEC", "EHF_CAM_T", "EHF_K"):
        np.testing.assert_array_equal(getattr(tehf, name), getattr(jehf, name))


def test_metrics_equal():
    rng = np.random.default_rng(6)
    for args in ((10, 3, 2), (0, 0, 0), (4, 4, 1), (7, 0, 0)):
        assert tmet.compute_prf1(*args) == jmet.compute_prf1(*args)
    for _ in range(5):
        p1, p2 = rng.normal(size=(2, 12, 2)) * 50
        assert tmet._bbox_iou_plus1(p1, p2) == jmet._bbox_iou_plus1(p1, p2)
    gt = [rng.normal(size=(20, 2)) * 30 + c for c in ([100, 100], [300, 120], [200, 400])]
    pred = [g + rng.normal(size=g.shape) * 3 for g in gt[::-1]] + [rng.normal(size=(20, 2))]
    valid = [np.ones(20, bool)] * len(gt)
    for p, g in ((pred, gt), ([], gt), (pred, [])):
        a, b = tmet.match_2d_greedy(p, g, valid[:len(g)]), jmet.match_2d_greedy(p, g, valid[:len(g)])
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    v1, v2 = rng.normal(size=(2, 3, 50, 3))
    pel1, pel2 = rng.normal(size=(2, 3, 1, 3))
    np.testing.assert_array_equal(tmet.pve(v1, v2, pel1, pel2), jmet.pve(v1, v2, pel1, pel2))
    np.testing.assert_array_equal(tmet.pa_pve(v1, v2), jmet.pa_pve(v1, v2))


def test_metrics_logger_equal(tmp_path):
    logs = {}
    for name, mod in (("t", tlog), ("j", jlog)):
        logger = mod.MetricsLogger(str(tmp_path / name), "run")
        logger.scalars({"pve": 12.5, "recall": 100.0}, 3, prefix="ehf-test-1/")
        logger.scalar("loss/total", 0.25, 4)
        logger.close()
        with open(tmp_path / name / "run" / "metrics.jsonl") as f:
            logs[name] = [{k: v for k, v in json.loads(ln).items() if k != "t"} for ln in f]
    assert logs["t"] == logs["j"] and len(logs["t"]) == 3
