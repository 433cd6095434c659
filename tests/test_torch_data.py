"""The port's copies of pure-Python training helpers equal the JAX package's.

``data/collate.py`` (on the port's own ``io/preprocessing.py``),
``data/prefetch.py::bounded_parallel_map`` and ``train/metrics.py::AverageMeter``
are copies; each is held to its original on the same seeded inputs, exactly.
"""

import numpy as np
import pytest

from multihmr_tpu.data import collate as jcol
from multihmr_tpu.data import prefetch as jpre
from multihmr_tpu.train import metrics as jmet
from multihmr_tpu_torch.data import collate as tcol
from multihmr_tpu_torch.data import prefetch as tpre
from multihmr_tpu_torch.train import metrics as tmet


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
