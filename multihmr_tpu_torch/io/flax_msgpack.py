"""Read flax msgpack files (``flax.serialization.to_bytes``, which the JAX
package's ``io/checkpoint.py::save_checkpoint`` writes) without flax and
without the ``msgpack`` package.

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
"""

from __future__ import annotations

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
