"""Minimal PLY reader (ascii + binary little-endian) — replaces the
``plyfile`` dependency the reference uses for EHF ground-truth meshes
(reference datasets/ehf.py).

A copy of the JAX package's module, held equal to it by
``tests/test_torch_data.py``.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_vertices(path: str) -> np.ndarray:
    """Return the vertex positions ``[V, 3]`` float32 of a PLY file."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_verts = 0
        props = []  # (name, dtype) for the vertex element
        in_vertex_element = False
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                in_vertex_element = name == "vertex"
                if in_vertex_element:
                    n_verts = int(count)
            elif line.startswith("property") and in_vertex_element:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list property in vertex element unsupported")
                props.append((parts[2], _TYPES[parts[1]]))
            elif line == "end_header":
                break

        if fmt == "ascii":
            rows = [f.readline().split()[: len(props)] for _ in range(n_verts)]
            data = np.array(rows, dtype=np.float64)
            names = [p[0] for p in props]
            idx = [names.index(c) for c in ("x", "y", "z")]
            return data[:, idx].astype(np.float32)
        elif fmt == "binary_little_endian":
            dt = np.dtype([(name, "<" + t) for name, t in props])
            data = np.frombuffer(f.read(dt.itemsize * n_verts), dtype=dt)
            return np.stack(
                [data["x"], data["y"], data["z"]], axis=-1
            ).astype(np.float32)
        raise ValueError(f"unsupported PLY format {fmt}")
