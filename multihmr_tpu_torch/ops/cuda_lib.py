"""Build, load and count the package's hand-written CUDA kernels.

The sources under ``multihmr_tpu_torch/csrc/`` compile with ``nvcc`` into
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds), loaded with ``ctypes``: one ``nvcc -c`` per source,
all started together, then one link. The library is built at first use into
``multihmr_tpu_torch/_build/``, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.

Every wrapper adds one to :data:`LAUNCHES` where it launches its kernel and
nowhere else, so a run can show that its path went through the kernels.

:func:`build_variants` and :func:`use_variant` build textual variants of one
source (a broken copy that a check must reject, or a kernel with part of its
work removed, to time) and swap one in for its C entry.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import types
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the namespace of the kernels' operators (``torch.ops.mhmr.*``: K1 and K5 in
# ops/attention.py, K2 in ops/norm.py)
OP_NAMESPACE = "mhmr"

# kernel name -> launches since the last reset
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmhmr_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> tuple[Path, float]:
    """Compile the kernels if this source hash has no library yet; the
    compiler's log (registers, shared memory, spills) goes to build.log.

    Returns (library path, build seconds — 0 when reused)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        log += link.stdout + link.stderr
        failed = [link.returncode] if link.returncode != 0 else []
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    (BUILD_DIR / "build.log").write_text(log)
    return so, seconds


@functools.cache
def library() -> ctypes.CDLL:
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.mhmr_flash_fwd_t.argtypes = [
        p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, f, i, p,
    ]
    lib.mhmr_flash_fwd_t.restype = i
    lib.mhmr_flash_fwd_std.argtypes = [
        p, p, p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, f, i, p,
    ]
    lib.mhmr_flash_fwd_std.restype = i
    lib.mhmr_flash_fwd_std_encode_ns.argtypes = [p, p, p, i, i, i, ll, ll, ll, i]
    lib.mhmr_flash_fwd_std_encode_ns.restype = ctypes.c_double
    lib.mhmr_flash_bwd_t.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
        ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, f, i, i, p,
    ]
    lib.mhmr_flash_bwd_t.restype = i
    lib.mhmr_layernorm_cm.argtypes = [p, p, p, p, i, i, i, f, i, i, p]
    lib.mhmr_layernorm_cm.restype = i
    lib.mhmr_error_string.argtypes = [i]
    lib.mhmr_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (launches that are refused,
    e.g. for too much shared memory, never run and report nothing later)."""
    if err != 0:
        msg = library().mhmr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def build_variants(source: str, table: dict, tmp) -> dict:
    """Start one nvcc per variant of ``csrc/<source>``: its text with the
    entry's ``[(old, new), ...]`` substitutions (each ``old`` found exactly
    once), compiled alone beside a copy of common.cuh in the directory
    ``tmp``, all at once. Returns {variant: (library path, nvcc process)}."""
    src = (CSRC / source).read_text()
    builds = {}
    for name, subs in table.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"variant {name!r}: {old!r} is not once in {source}")
            text = text.replace(old, new)
        d = Path(tempfile.mkdtemp(prefix=f"{Path(source).stem}_", dir=tmp))
        shutil.copy(CSRC / "common.cuh", d)
        (d / source).write_text(text)
        builds[name] = (d / "lib.so", subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return builds


@contextlib.contextmanager
def use_variant(name: str, build: tuple, entry: str):
    """Inside the block the wrappers call the variant library's C entry
    ``entry`` (``build`` from :func:`build_variants`; it is waited for here)
    and the sound library's for everything else. Launches count as usual."""
    global library
    so, proc = build
    if proc.returncode is None:
        proc.log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r} did not build:\n{proc.log}")
    sound = library()
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes, fn.restype = getattr(sound, entry).argtypes, getattr(sound, entry).restype
    # the sound library's bound entries (library() set their argtypes)
    shim = types.SimpleNamespace(**{k: f for k, f in vars(sound).items() if k.startswith("mhmr_")})
    setattr(shim, entry, fn)
    sound_library = library
    library = lambda: shim  # noqa: E731
    try:
        yield
    finally:
        library = sound_library
