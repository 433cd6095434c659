"""The compiled host libraries (``multihmr_tpu/io/native.py``): the overlay
rasterizer, and the image decoder, resampler and prefetching loader.

Two libraries, each built from the checkout at first use with the host C++
compiler (``$CXX``, else ``g++``) into ``multihmr_tpu_torch/_build/``, named
by a hash of the source and the flags, and bound with ``ctypes``:

  * ``csrc/raster.cpp``, ``mh_rasterize`` of ``native/multihmr_native.cpp``
    alone: standard headers only (:func:`rasterize`, :func:`native_available`);
  * ``csrc/image_io.cpp``, that file's decoder and loader, linked with
    libjpeg and libpng (:func:`decode_file`, :func:`preprocess_file`,
    :class:`NativeImageLoader`, :func:`image_io_available`). It is a library
    of its own so that the renderer builds where those codecs are absent.

No ``-march=native``: the libraries run on any x86-64 or aarch64 host, and
``-ffp-contract=off`` rounds each product and sum on its own. A build or
load that fails raises; the renderer does not switch to its numpy version
(``render/render.py::_rasterize``, kept beside it as the plain version), and
the image functions do not switch to PIL (the demo chooses its path before
it starts, and says which).

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "raster.cpp"
IMAGE_IO_SOURCE = _PKG / "csrc" / "image_io.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
IMAGE_IO_FLAGS = ("-pthread",)  # the loader's worker threads
IMAGE_IO_LIBS = ("-ljpeg", "-lpng")


def _cxx(source: Path) -> str:
    for cand in (os.environ.get("CXX", ""), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError(f"no C++ compiler for csrc/{source.name}: set CXX or put g++ on PATH")


def _library_path(source: Path, stem: str, flags: tuple) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _compile(source: Path, stem: str, flags: tuple, libs: tuple = ()) -> tuple[Path, float]:
    """Compile ``source`` unless its hash has a library already. Returns
    (library path, build seconds — 0 when reused)."""
    so = _library_path(source, stem, flags + libs)
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_cxx(source), *flags, "-o", str(tmp), str(source), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {source.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so, time.perf_counter() - t0


@functools.cache
def build() -> tuple[Path, float]:
    """The rasterizer's library: (path, build seconds — 0 when reused)."""
    return _compile(SOURCE, "libmhmr_raster", CXX_FLAGS)


@functools.cache
def build_image_io() -> tuple[Path, float]:
    """The image library (libjpeg, libpng): (path, build seconds — 0 when
    reused). Raises where the codecs' headers or libraries are missing."""
    return _compile(IMAGE_IO_SOURCE, "libmhmr_image_io", CXX_FLAGS + IMAGE_IO_FLAGS,
                    IMAGE_IO_LIBS)


@functools.cache
def _load() -> ctypes.CDLL:
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    fp, i, f = ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float
    lib.mh_rasterize.restype = None
    lib.mh_rasterize.argtypes = [fp, i, ctypes.POINTER(ctypes.c_int32), i, fp, i, i,
                                 f, f, f, fp, fp]
    return lib


def rasterize(
    verts: np.ndarray,
    faces: np.ndarray,
    K: np.ndarray,
    width: int,
    height: int,
    color=(0.65, 0.74, 0.86),
    rgb: Optional[np.ndarray] = None,
    depth: Optional[np.ndarray] = None,
):
    """Z-buffer rasterization of one mesh into ``rgb [H, W, 3]`` and
    ``depth [H, W]`` (fp32, C-contiguous; new ones if not given, depth at
    +inf), updated in place and returned."""
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    Kf = np.ascontiguousarray(K, np.float32).reshape(9)
    if rgb is None:
        rgb = np.zeros((height, width, 3), np.float32)
    if depth is None:
        depth = np.full((height, width), np.inf, np.float32)
    for name, a, shape in (("rgb", rgb, (height, width, 3)), ("depth", depth, (height, width))):
        if a.dtype != np.float32 or a.shape != shape or not a.flags.c_contiguous:
            raise ValueError(f"rasterize: {name} must be C-contiguous float32 {shape}, got "
                             f"{a.dtype} {a.shape}")
    lib.mh_rasterize(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        Kf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), width, height,
        float(color[0]), float(color[1]), float(color[2]),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return rgb, depth


def native_available() -> bool:
    """Whether the rasterizer builds and loads here (a probe: the renderer
    itself calls :func:`rasterize`, which raises on a failed build)."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


@functools.cache
def _load_image_io() -> ctypes.CDLL:
    so, _ = build_image_io()
    lib = ctypes.CDLL(str(so))
    i, fp = ctypes.c_int, ctypes.POINTER(ctypes.c_float)
    lib.mh_preprocess_file.restype = i
    lib.mh_preprocess_file.argtypes = [ctypes.c_char_p, i, i, fp]
    lib.mh_decode_file.restype = i
    lib.mh_decode_file.argtypes = [ctypes.c_char_p, ctypes.POINTER(i), ctypes.POINTER(i),
                                   ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.mh_loader_create.restype = ctypes.c_void_p
    lib.mh_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), i, i, i, i, i]
    lib.mh_loader_next.restype = i
    lib.mh_loader_next.argtypes = [ctypes.c_void_p, fp]
    lib.mh_loader_total.restype = i
    lib.mh_loader_total.argtypes = [ctypes.c_void_p]
    lib.mh_loader_destroy.restype = None
    lib.mh_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def image_io_available() -> bool:
    """Whether the image library builds and loads here (a probe: the
    functions below raise on a failed build)."""
    try:
        _load_image_io()
        return True
    except (RuntimeError, OSError):
        return False


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def preprocess_file(path: str, img_size: int, imagenet_norm: bool = True) -> np.ndarray:
    """Decode + BICUBIC contain + centred zero pad + ImageNet normalization
    → float32 ``[S, S, 3]``; raises ``IOError`` if the file does not decode."""
    lib = _load_image_io()
    out = np.empty((img_size, img_size, 3), np.float32)
    if not lib.mh_preprocess_file(os.fsencode(path), img_size, int(imagenet_norm), _fptr(out)):
        raise IOError(f"native decode failed for {path}")
    return out


def decode_file(path: str) -> np.ndarray:
    """Decode a JPEG or PNG to RGB uint8 ``[H, W, 3]``; raises ``IOError`` if
    it does not decode."""
    lib = _load_image_io()
    h, w = ctypes.c_int(), ctypes.c_int()
    # first call: the size from the header alone
    if not lib.mh_decode_file(os.fsencode(path), ctypes.byref(h), ctypes.byref(w), None, 0):
        raise IOError(f"native decode failed for {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if not lib.mh_decode_file(os.fsencode(path), ctypes.byref(h), ctypes.byref(w),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes):
        raise IOError(f"native decode failed for {path}")
    return out


class NativeImageLoader:
    """Prefetching image loader: ``n_threads`` workers (0: one per logical
    CPU) decode and :func:`preprocess_file` the paths in index order into a
    queue of at most ``max_queue`` images.

    Iterating yields ``(index, [S, S, 3] float32)`` in completion order, once
    per path; a file that does not decode yields ``-(index + 1)`` with a zero
    tensor. The iteration stops at :attr:`EXHAUSTED`. :meth:`close` (or the
    ``with`` block's end, or garbage collection) stops the workers and joins
    them, also before every image was taken.
    """

    EXHAUSTED = -(1 << 30)

    def __init__(self, paths: Sequence[str], img_size: int, n_threads: int = 0,
                 imagenet_norm: bool = True, max_queue: int = 8):
        lib = _load_image_io()
        encoded = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(encoded))(*encoded)  # copied by the library
        self.img_size = img_size
        self._lib = lib
        self._handle = lib.mh_loader_create(arr, len(encoded), img_size, n_threads,
                                            int(imagenet_norm), max_queue)
        self._close = weakref.finalize(self, lib.mh_loader_destroy, self._handle)

    def _live(self) -> int:
        if not self._close.alive:
            raise ValueError("NativeImageLoader is closed")
        return self._handle

    def __iter__(self):
        while True:
            out = np.empty((self.img_size, self.img_size, 3), np.float32)
            idx = self._lib.mh_loader_next(self._live(), _fptr(out))
            if idx == self.EXHAUSTED:
                return
            yield idx, out

    def __len__(self) -> int:
        return self._lib.mh_loader_total(self._live())

    def close(self) -> None:
        self._close()  # runs mh_loader_destroy once

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
