"""Body-model assets as numpy arrays (``multihmr_tpu/bodymodel/assets.py``).

Plain numpy, so these are copies of the JAX package's loaders rather than
imports (``multihmr_tpu.bodymodel`` imports jax). Each loader returns a dict
of arrays keyed like :class:`~multihmr_tpu_torch.bodymodel.core.BodyModel`;
``BodyModel.from_arrays`` puts them on a device. With the same seed,
:func:`synthetic_body_model` gives the same arrays as the JAX package's.
The SMPL pkls unpickle without chumpy (:class:`_TolerantUnpickler`).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from multihmr_tpu_torch.bodymodel import constants

SHAPE_SPACE_DIM = 300  # full SMPL-X shape space; num_betas slices into it


def _to_np(x) -> np.ndarray:
    """Dense numpy from arrays, scipy sparse matrices (the J_regressors) and
    chumpy arrays inside SMPL pkls."""
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    if hasattr(x, "r"):  # chumpy
        return np.asarray(x.r)
    return np.asarray(x)


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickle SMPL pkl files without chumpy installed: any missing module
    resolves to a stub whose instances expose ``.r`` (their array)."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            class _Stub:
                def __init__(self, *a, **k):
                    pass

                def __setstate__(self, state):
                    self.__dict__.update(state if isinstance(state, dict) else {})

                @property
                def r(self):
                    for key in ("x", "a", "_data"):
                        if key in self.__dict__:
                            return np.asarray(self.__dict__[key])
                    raise ValueError("cannot extract array from stub pickle object")

            _Stub.__name__ = name
            return _Stub


def load_smplx_npz(path: str, num_betas: int = 10, num_expression: int = 10) -> dict:
    """Official ``SMPLX_{GENDER}.npz`` (``use_pca=False, flat_hand_mean=True``):
    expression dirs are shapedirs[..., 300:], or [..., 10:] in legacy
    20-column assets."""
    data = np.load(path, allow_pickle=True)
    shapedirs = _to_np(data["shapedirs"]).astype(np.float32)
    if shapedirs.shape[-1] >= SHAPE_SPACE_DIM:
        exprdirs = shapedirs[..., SHAPE_SPACE_DIM:SHAPE_SPACE_DIM + num_expression]
    else:
        if num_betas > 10:
            raise ValueError(
                f"num_betas={num_betas} needs the {SHAPE_SPACE_DIM}-column SMPL-X "
                f"shape space; this legacy asset has {shapedirs.shape[-1]} columns")
        exprdirs = shapedirs[..., 10:10 + num_expression]
    posedirs = _to_np(data["posedirs"]).astype(np.float32)
    V = posedirs.shape[0]
    parents = _to_np(data["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    return {
        "v_template": _to_np(data["v_template"]).astype(np.float32),
        "shapedirs": shapedirs[..., :num_betas],
        "exprdirs": exprdirs,
        "posedirs": posedirs.reshape(V * 3, -1).T,
        "J_regressor": _to_np(data["J_regressor"]).astype(np.float32),
        "lbs_weights": _to_np(data["weights"]).astype(np.float32),
        "parents": parents.astype(np.int32),
        "extra_joint_vertex_ids": np.asarray(constants.extra_joint_vertex_ids("smplx"), np.int32),
        "faces": _to_np(data["f"]).astype(np.int32),
        "lmk_faces_idx": _to_np(data["lmk_faces_idx"]).astype(np.int32),
        "lmk_bary_coords": _to_np(data["lmk_bary_coords"]).astype(np.float32),
    }


def load_smpl_pkl(path: str, num_betas: int = 10) -> dict:
    """Official ``SMPL_{GENDER}.pkl`` (6,890 vertices, 24 joints), the 3DPW
    ground truth's body model (reference train.py:42-43): the 21 vertex
    keypoints of the SMPL topology, no expression and no landmarks."""
    with open(path, "rb") as f:
        data = _TolerantUnpickler(f, encoding="latin1").load()
    posedirs = _to_np(data["posedirs"]).astype(np.float32)
    V = posedirs.shape[0]
    parents = _to_np(data["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    return {
        "v_template": _to_np(data["v_template"]).astype(np.float32),
        "shapedirs": _to_np(data["shapedirs"]).astype(np.float32)[..., :num_betas],
        "exprdirs": np.zeros((V, 3, 0), np.float32),
        "posedirs": posedirs.reshape(V * 3, -1).T,
        "J_regressor": _to_np(data["J_regressor"]).astype(np.float32),
        "lbs_weights": _to_np(data["weights"]).astype(np.float32),
        "parents": parents.astype(np.int32),
        "extra_joint_vertex_ids": np.asarray(constants.extra_joint_vertex_ids("smpl"), np.int32),
        "faces": _to_np(data["f"]).astype(np.int32),
        "lmk_faces_idx": np.zeros((0,), np.int32),
        "lmk_bary_coords": np.zeros((0, 3), np.float32),
    }


def load_smplx2smpl(path: str) -> np.ndarray:
    """The 10475 → 6890 vertex regressor of the 3DPW evaluation (reference
    train.py:44-45; ``smplx2smpl.pkl`` holds a scipy sparse 'matrix')."""
    with open(path, "rb") as f:
        data = _TolerantUnpickler(f, encoding="latin1").load()
    m = data["matrix"] if isinstance(data, dict) else data
    return _to_np(m).astype(np.float32)


def load_j_regressor_h36m(path: str) -> np.ndarray:
    """``J_regressor_h36m.npy`` [17, 6890] (reference train.py:400)."""
    return np.load(path).astype(np.float32)


def synthetic_body_model(
    num_vertices: int = 128,
    num_joints: int = 12,
    num_betas: int = 10,
    num_expression: int = 10,
    num_extra: int = 4,
    num_lmk: int = 3,
    seed: int = 0,
) -> dict:
    """Small deterministic body model with the SMPL-X structure: a chain with
    branches, smooth random blendshapes and distance-based skinning weights."""
    rng = np.random.default_rng(seed)
    parents = np.zeros(num_joints, dtype=np.int64)
    parents[0] = -1
    for j in range(1, num_joints):
        parents[j] = (j - 1) if j % 3 != 0 else max(0, j - 3)
    joints = np.cumsum(rng.normal(scale=0.15, size=(num_joints, 3)), axis=0)
    joints[0] = 0.0
    owner = rng.integers(0, num_joints, size=num_vertices)
    v_template = joints[owner] + rng.normal(scale=0.08, size=(num_vertices, 3))
    d2 = ((v_template[:, None] - joints[None]) ** 2).sum(-1)
    w = np.exp(-d2 / 0.02)
    w = w / w.sum(-1, keepdims=True)
    Jr = np.exp(-d2.T / 0.005)
    Jr = Jr / Jr.sum(-1, keepdims=True)
    order = np.lexsort((v_template[:, 2], v_template[:, 1], v_template[:, 0]))
    f0 = order[np.arange(3 * num_vertices) % num_vertices]
    f1 = order[(np.arange(3 * num_vertices) + 1) % num_vertices]
    f2 = order[(np.arange(3 * num_vertices) + 2) % num_vertices]
    faces = np.stack([f0, f1, f2], axis=1)
    f32 = lambda a: np.asarray(a, np.float32)
    return {
        "v_template": f32(v_template),
        "shapedirs": f32(rng.normal(scale=0.01, size=(num_vertices, 3, num_betas))),
        "exprdirs": f32(rng.normal(scale=0.003, size=(num_vertices, 3, num_expression))),
        "posedirs": f32(rng.normal(scale=0.001,
                                   size=(9 * (num_joints - 1), num_vertices * 3))),
        "J_regressor": f32(Jr),
        "lbs_weights": f32(w),
        "parents": parents.astype(np.int32),
        "extra_joint_vertex_ids": rng.integers(0, num_vertices, size=num_extra).astype(np.int32),
        "faces": faces.astype(np.int32),
        "lmk_faces_idx": rng.integers(0, faces.shape[0], size=num_lmk).astype(np.int32),
        "lmk_bary_coords": f32(rng.dirichlet(np.ones(3), size=num_lmk)),
    }


def smplx_like_synthetic(num_betas: int = 10) -> dict:
    """Synthetic model with SMPL-X's dimensions (10,475 vertices, 55 joints,
    21 vertex keypoints, 51 landmarks), for runs without the licensed asset."""
    return synthetic_body_model(
        num_vertices=10475, num_joints=55, num_betas=max(num_betas, 11),
        num_expression=10, num_extra=21, num_lmk=51, seed=0,
    )


def load_mean_params(path: Optional[str], nrot: int = 53, num_betas: int = 10) -> dict:
    """``smpl_mean_params.npz`` or neutral defaults: 6d ``pose [1, nrot*6]``,
    ``shape [1, num_betas]``, ``cam [1, 3]``, ``expression [1, 10]``.

    Joints past the file's 24 take the identity 6d ``[1,0,0,0,1,0]``, as in
    the JAX package."""
    if path is not None and os.path.exists(path):
        mean = np.load(path)
        pose24 = mean["pose"].astype(np.float32).reshape(1, -1)
        shape = mean["shape"].astype(np.float32).reshape(1, -1)
        cam = mean["cam"].astype(np.float32).reshape(1, -1)
    else:
        pose24 = np.tile(np.array([[1, 0, 0, 0, 1, 0]], np.float32), (1, 24)).reshape(1, -1)
        shape = np.zeros((1, 10), np.float32)
        cam = np.array([[0.9, 0.0, 0.0]], np.float32)
    if nrot == 53:
        pose = np.tile(np.array([[1, 0, 0, 0, 1, 0]], np.float32), (1, nrot))
        pose[:, :24 * 6] = pose24[:, :24 * 6]
    else:
        pose = pose24
    shape = shape[:, :num_betas]
    if shape.shape[1] < num_betas:
        shape = np.concatenate([shape, np.zeros((1, num_betas - shape.shape[1]), np.float32)], 1)
    return {"pose": pose, "shape": shape, "cam": cam, "expression": np.zeros((1, 10), np.float32)}
