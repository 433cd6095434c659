"""The compiled host rasterizer (``multihmr_tpu/io/native.py``, its
``rasterize`` and ``native_available``).

``csrc/raster.cpp`` is ``mh_rasterize`` of ``native/multihmr_native.cpp``
alone: standard headers only, so it needs no image codecs. It is built from
the checkout at first use with the host C++ compiler (``$CXX``, else
``g++``) into ``multihmr_tpu_torch/_build/``, named by a hash of the source
and the flags, and bound with ``ctypes``. No ``-march=native``: the library
runs on any x86-64 or aarch64 host. A build or load that fails raises; the
renderer does not switch to its numpy version
(``render/render.py::_rasterize``, kept beside it as the plain version).

Nothing here runs at import time. The JAX module's native JPEG/PNG decoder
and prefetching loader are not ported (they need libjpeg and libpng).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "raster.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")


def _cxx() -> str:
    for cand in (os.environ.get("CXX", ""), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler for csrc/raster.cpp: set CXX or put g++ on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmhmr_raster_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> tuple[Path, float]:
    """Compile the rasterizer unless this source hash has a library already.
    Returns (library path, build seconds — 0 when reused)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so, time.perf_counter() - t0


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
