"""The port's image library (``csrc/image_io.cpp`` through ``io/native.py``):
the decoder, ``preprocess_file`` and the prefetching loader against the JAX
package's ``multihmr_tpu/io/native.py`` (its committed library) and against
PIL, on JPEG and PNG files the tests write, including the sizes of
tests/test_native.py:53-80 (an odd pad ≡ 3 mod 4, a .5 contain tie).

Limits:
  * decode: equal to the JAX library (the same libjpeg and libpng); mean
    |Δ| < 1.5 levels against PIL (tests/test_native.py:30: IDCT rounding);
  * preprocess against PIL contain + pad + normalize: max |Δ| < 0.018 (one
    uint8 level is 1/255/0.225 = 0.0174) and mean < 1e-3
    (tests/test_native.py:51, :78-79);
  * preprocess against the JAX library: equal but for values one uint8 level
    apart on at most 1e-4 of them. The JAX library is built with
    ``-march=native``, whose FMAs round a resampled sum differently from
    the port's ``-ffp-contract=off`` build (17 of 2,408,448 values at 896).
"""

import os
import threading

import numpy as np
import pytest

from multihmr_tpu.io import native as jnative
from multihmr_tpu_torch.io import native
from multihmr_tpu_torch.io.preprocessing import normalize_nhwc, preprocess_array
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

LEVEL = 1 / 255 / 0.225 + 1e-4  # one uint8 level, normalized (the largest std divisor)
JAX_SHARE = 1e-4

# (h, w, S): landscape and portrait downscales, the odd-pad case and the
# .5-tie case of tests/test_native.py, and an upscale
CASES = [(720, 1280, 224), (1000, 1024, 128), (250, 1000, 674), (300, 200, 160), (40, 48, 56)]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(5)
    out = []
    for h, w, S in CASES:
        # smooth content plus noise: a photo's spectrum, not only white noise
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                         ((xx + yy) % 256)], -1)
        img = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)
        for ext in ("jpg", "png"):
            p = str(d / f"{h}x{w}.{ext}")
            Image.fromarray(img).save(p)
            out.append((p, S))
    return out


def _pil(path, S):
    from PIL import Image, ImageOps

    pil = Image.open(path).convert("RGB")
    return normalize_nhwc(np.asarray(ImageOps.pad(ImageOps.contain(pil, (S, S)), size=(S, S))))


def test_jax_library_loads_here():
    assert jnative.native_available() and native.image_io_available()


def test_decode_matches_jax_and_pil(images):
    from PIL import Image

    for path, _ in images:
        ours = native.decode_file(path)
        np.testing.assert_array_equal(ours, jnative.decode_file(path), err_msg=path)
        ref = np.asarray(Image.open(path).convert("RGB"))
        assert ours.shape == ref.shape and ours.dtype == np.uint8
        assert np.mean(np.abs(ours.astype(int) - ref.astype(int))) < 1.5, path


def test_preprocess_matches_pil(images):
    for path, S in images:
        ours = native.preprocess_file(path, S)
        assert ours.shape == (S, S, 3) and ours.dtype == np.float32
        for ref in (_pil(path, S), preprocess_array(np.asarray(native.decode_file(path)), S).x):
            d = np.abs(ours - ref)
            assert d.max() < 0.018 and d.mean() < 1e-3, (path, S, d.max(), d.mean())


def test_preprocess_matches_jax_library(images):
    for path, S in images:
        for S2 in (S, 896):
            ours, theirs = native.preprocess_file(path, S2), jnative.preprocess_file(path, S2)
            d = np.abs(ours - theirs)
            assert d.max() <= LEVEL, (path, S2, d.max())
            assert (d > 0).mean() <= JAX_SHARE, (path, S2, int((d > 0).sum()))


def test_preprocess_unnormalized(images):
    path, S = images[1]
    raw = native.preprocess_file(path, S, imagenet_norm=False)
    assert 0.0 <= raw.min() and raw.max() <= 1.0
    np.testing.assert_allclose(normalize_nhwc(np.round(raw * 255).astype(np.uint8)),
                               native.preprocess_file(path, S), atol=1e-6)


def test_loader_yields_every_index_as_preprocess_file(images):
    paths = [p for p, _ in images]
    with native.NativeImageLoader(paths, img_size=96, n_threads=3, max_queue=2) as loader:
        assert len(loader) == len(paths)
        got = dict(loader)
    assert sorted(got) == list(range(len(paths)))
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(got[i], native.preprocess_file(p, 96), err_msg=p)


def test_loader_bad_path(images, tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 not a jpeg")
    loader = native.NativeImageLoader(["/nonexistent.jpg"], img_size=32)
    assert list(idx for idx, _ in loader) == [-1]  # decode failure: -(i + 1)
    loader.close()
    paths = [images[0][0], str(bad), images[1][0]]
    with native.NativeImageLoader(paths, img_size=32, n_threads=2) as loader:
        items = dict(loader)
    assert sorted(items) == [-2, 0, 2] and not items[-2].any()
    with pytest.raises(IOError, match="bad.jpg"):
        native.preprocess_file(str(bad), 32)
    with pytest.raises(IOError, match="bad.jpg"):
        native.decode_file(str(bad))


def test_loader_closed_early_joins_its_workers(images):
    """Closing a loader with images still queued and workers still decoding
    stops and joins them; a closed loader refuses to be read."""
    paths = [p for p, _ in images] * 4
    done = threading.Event()

    def run():
        loader = native.NativeImageLoader(paths, img_size=224, n_threads=4, max_queue=1)
        it = iter(loader)
        next(it)
        loader.close()
        loader.close()  # once only
        with pytest.raises(ValueError, match="closed"):
            next(it)
        with pytest.raises(ValueError, match="closed"):
            len(loader)
        done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert done.is_set() and not t.is_alive()
    del_loader = native.NativeImageLoader(paths, img_size=64, n_threads=2, max_queue=1)
    del del_loader  # garbage collection joins the workers too


def test_image_io_build_failure_raises(monkeypatch, tmp_path, images):
    """No quiet fallback: a build that fails raises from every entry, and the
    probe says so."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "IMAGE_IO_LIBS", native.IMAGE_IO_LIBS + ("-lno_such_codec",))
    caches = (native.build, native._load, native.build_image_io, native._load_image_io)
    for c in caches:
        c.cache_clear()
    try:
        assert not native.image_io_available()
        with pytest.raises(RuntimeError, match="image_io.cpp failed"):
            native.preprocess_file(images[0][0], 32)
        with pytest.raises(RuntimeError, match="image_io.cpp failed"):
            native.NativeImageLoader([images[0][0]], 32)
        assert native.native_available()  # the rasterizer is a library of its own
        # no half-built image library left behind
        assert [f.startswith("libmhmr_raster_") for f in os.listdir(tmp_path)] == [True]
    finally:
        for c in caches:
            c.cache_clear()


def _section(text, start, end):
    i = text.index(start)
    return text[i:text.index(end, i) + len(end)]


def test_image_io_source_is_the_jax_packages():
    """The copy rule: csrc/image_io.cpp's helpers, loader and C entry points
    are native/multihmr_native.cpp's, mh_rasterize (csrc/raster.cpp) left out."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax_src = open(os.path.join(root, "native", "multihmr_native.cpp")).read()
    port_src = open(os.path.join(root, "multihmr_tpu_torch", "csrc", "image_io.cpp")).read()
    body = ("namespace {\n", "}  // namespace\n")
    assert _section(port_src, *body) == _section(jax_src, *body)
    entries = ("// Decode + preprocess one file", "}  // extern \"C\"\n")
    assert _section(port_src, *entries) == _section(jax_src, *entries)
    assert "void mh_rasterize" not in port_src
