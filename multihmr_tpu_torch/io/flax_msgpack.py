"""Read and write flax msgpack files (``flax.serialization.to_bytes``, which
the JAX package's ``io/checkpoint.py::save_checkpoint`` writes) without flax
and without the ``msgpack`` package.

The decoder reads the subset of msgpack that ``msgpack_serialize`` writes:
maps, arrays, str, bin, ints, floats, nil and bool, and two ext types:

  * 1, an ndarray: a packed ``(shape, dtype name, C-order bytes)``;
  * 3, a numpy scalar, packed the same way with shape ``()``.

Any other ext code raises (2, a Python complex, has no use in a parameter
tree), as does a dtype outside ``float32``, ``float16``, ``int32``,
``int64``, ``uint8``, ``bool`` and ``bfloat16``. An array is an
``np.frombuffer`` view of the file's buffer, not a copy; numpy has no
bfloat16, so a bfloat16 array is read as ``uint16`` and viewed as a
``torch.bfloat16`` tensor. Leaves that flax split into
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` dicts
(over ``2**30`` bytes) are joined back. Lists and tuples come back as flax
wrote them: maps keyed ``"0"``, ``"1"``, ...

The writer (:func:`dump_parts`, :func:`write_flax_checkpoint`) makes the
bytes ``to_bytes`` makes for the same tree of numpy arrays (a leaf that
flax would chunk raises), and the ``.json`` that ``save_checkpoint``
writes beside them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_SCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"
DTYPES = ("float32", "float16", "int32", "int64", "uint8", "bool", "bfloat16")

# fixed-width headers: type byte → (struct format, size)
_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
_INT = {0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN8, _LEN16, _LEN32 = ">B", ">H", ">I"
_STR = {0xD9: _LEN8, 0xDA: _LEN16, 0xDB: _LEN32}
_BIN = {0xC4: _LEN8, 0xC5: _LEN16, 0xC6: _LEN32}
_EXT = {0xC7: _LEN8, 0xC8: _LEN16, 0xC9: _LEN32}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_ARRAY = {0xDC: _LEN16, 0xDD: _LEN32}
_MAP = {0xDE: _LEN16, 0xDF: _LEN32}


def _array(data: memoryview, shape, dtype: str):
    if dtype not in DTYPES:
        raise ValueError(f"flax msgpack: unsupported dtype {dtype!r}")
    shape = tuple(shape)
    if dtype == "bfloat16":
        a = np.frombuffer(data, np.uint16).reshape(shape)
        if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
            a = a.copy()
        return torch.from_numpy(a).view(torch.bfloat16)
    return np.frombuffer(data, np.dtype(dtype)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _decode(mv: memoryview, pos: int, views: bool = False):
    """(object, next position) of the msgpack value at ``pos``. ``views``:
    bin as memoryview slices (inside an ext), else bytes."""
    t = mv[pos]
    pos += 1

    def fixed(fmt):
        nonlocal pos
        (v,) = struct.unpack_from(fmt, mv, pos)
        pos += struct.calcsize(fmt)
        return v

    def take(n):
        nonlocal pos
        if pos + n > len(mv):
            raise ValueError("flax msgpack: truncated")
        out = mv[pos:pos + n]
        pos += n
        return out

    if t <= 0x7F:
        return t, pos
    if t >= 0xE0:
        return t - 0x100, pos
    if 0x80 <= t <= 0x8F or t in _MAP:
        n = t & 0x0F if t <= 0x8F else fixed(_MAP[t])
        out = {}
        for _ in range(n):
            k, pos = _decode(mv, pos)
            out[k], pos = _decode(mv, pos)
        return (_unchunk(out) if out.get(CHUNKED) is True else out), pos
    if 0x90 <= t <= 0x9F or t in _ARRAY:
        n = t & 0x0F if t <= 0x9F else fixed(_ARRAY[t])
        out = []
        for _ in range(n):
            v, pos = _decode(mv, pos, views)
            out.append(v)
        return out, pos
    if 0xA0 <= t <= 0xBF or t in _STR:
        n = t & 0x1F if t <= 0xBF else fixed(_STR[t])
        return str(take(n), "utf-8"), pos
    if t in _BIN:
        data = take(fixed(_BIN[t]))
        return (data if views else data.tobytes()), pos
    if t == 0xC0:
        return None, pos
    if t in (0xC2, 0xC3):
        return t == 0xC3, pos
    if t == 0xCA:
        return fixed(">f"), pos
    if t == 0xCB:
        return fixed(">d"), pos
    if t in _UINT:
        return fixed(_UINT[t]), pos
    if t in _INT:
        return fixed(_INT[t]), pos
    if t in _EXT or t in _FIXEXT:
        n = _FIXEXT[t] if t in _FIXEXT else fixed(_EXT[t])
        code = struct.unpack_from(">b", mv, pos)[0]
        pos += 1
        payload = take(n)
        if code not in (EXT_NDARRAY, EXT_SCALAR):
            raise ValueError(f"flax msgpack: unsupported ext type {code}")
        (shape, dtype, data), end = _decode(payload, 0, views=True)
        if end != n:
            raise ValueError("flax msgpack: malformed ndarray payload")
        a = _array(data, shape, dtype)
        return (a[()] if code == EXT_SCALAR else a), pos
    raise ValueError(f"flax msgpack: unsupported type byte 0x{t:02x}")


def loads(buf) -> object:
    """Decode one flax msgpack value from a bytes-like object. Arrays are
    views of ``buf``."""
    mv = memoryview(buf).cast("B")
    try:
        obj, end = _decode(mv, 0)
    except (IndexError, struct.error) as err:
        raise ValueError(f"flax msgpack: truncated ({err})") from err
    if end != len(mv):
        raise ValueError(f"flax msgpack: {len(mv) - end} bytes after the value")
    return obj


def load(path: str) -> object:
    """:func:`loads` of a file, read once into a writable buffer that the
    returned arrays view."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    return loads(buf)


# ---- the writer ----


def _mp_len(n, fix, fix_max, codes):
    """A msgpack length header: the fix form below ``fix_max``, else the
    8/16/32-bit code (None where msgpack has no 8-bit form)."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _mp_int(v):
    if -0x20 <= v < 0x80:
        return struct.pack(">b" if v < 0 else ">B", v)
    for code, fmt, lo, hi in ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
                              (0xCE, ">I", 0, 0xFFFFFFFF), (0xCF, ">Q", 0, 2**64 - 1),
                              (0xD0, ">b", -0x80, -1), (0xD1, ">h", -0x8000, -1),
                              (0xD2, ">i", -2**31, -1), (0xD3, ">q", -2**63, -1)):
        if lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: int {v} out of range")


def _mp_str(v):
    b = v.encode()
    return _mp_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b


def _mp_ndarray(a, code):
    """flax's ext: ``packb((shape, dtype name, C-order bytes))``."""
    data = np.ascontiguousarray(a).tobytes()
    inner = (_mp_len(3, 0x90, 16, (None, 0xDC, 0xDD)) + _mp_len(a.ndim, 0x90, 16, (None, 0xDC, 0xDD))
             + b"".join(_mp_int(int(d)) for d in a.shape) + _mp_str(a.dtype.name)
             + _mp_len(len(data), 0, 0, (0xC4, 0xC5, 0xC6)))
    n = len(inner) + len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixext[n]]) if n in fixext else _mp_len(n, 0, 0, (0xC7, 0xC8, 0xC9))
    return [head + bytes([code]) + inner, data]


def dump_parts(obj):
    """The bytes of ``flax.serialization.to_bytes(obj)``, in parts (the
    arrays' data as separate parts), for a tree of dicts, lists, tuples,
    numpy arrays and scalars, str, bytes, int, float, bool and None: the
    inverse of :func:`loads`, a writer of the JAX package's checkpoint
    layout without flax or msgpack.
    Lists and tuples become maps keyed "0", "1", ... as flax's state dicts
    make them; a leaf over flax's 2**30-byte chunk size raises."""
    if isinstance(obj, (list, tuple)):
        obj = {str(i): v for i, v in enumerate(obj)}
    if isinstance(obj, dict):
        parts = [_mp_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF))]
        for k, v in obj.items():
            parts.append(_mp_str(str(k)))
            parts += dump_parts(v)
        return parts
    if isinstance(obj, np.ndarray):
        if obj.nbytes > 2**30:
            raise ValueError("a leaf over flax's chunk size: not written here")
        return _mp_ndarray(obj, 1)
    if isinstance(obj, np.generic):
        return _mp_ndarray(np.asarray(obj), 3)
    if obj is None:
        return [b"\xc0"]
    if isinstance(obj, bool):
        return [b"\xc3" if obj else b"\xc2"]
    if isinstance(obj, int):
        return [_mp_int(obj)]
    if isinstance(obj, float):
        return [b"\xcb" + struct.pack(">d", obj)]
    if isinstance(obj, str):
        return [_mp_str(obj)]
    if isinstance(obj, bytes):
        return [_mp_len(len(obj), 0, 0, (0xC4, 0xC5, 0xC6)), obj]
    raise TypeError(f"flax msgpack: cannot write {type(obj).__name__}")


def write_flax_checkpoint(ckpt_dir, tree, epoch, cfg):
    """What the JAX package's ``save_checkpoint`` writes: ``ckpt_{epoch:06d}
    .msgpack`` (flax ``to_bytes`` of ``tree``) and its ``.json``; returns
    the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{epoch:06d}.msgpack")
    with open(path, "wb") as f:
        for part in dump_parts(tree):
            f.write(part)
    with open(os.path.join(ckpt_dir, f"ckpt_{epoch:06d}.json"), "w") as f:
        json.dump({"epoch": epoch, "config": dataclasses.asdict(cfg)}, f)
    return path
