"""Blendshapes + forward kinematics + linear blend skinning
(``multihmr_tpu/bodymodel/core.py``).

Plain fp32 torch. The JAX package runs this geometry at
``precision=HIGHEST``, so on CUDA the caller keeps TF32 off.

The forward kinematics compose the bones one after another in a Python
loop, under the span ``multihmr.fk`` (``utils/profiling.py::span``);
:data:`FK` counts its calls and the compositions they took. On a card under
``inference_mode`` the loop's kernels are captured once per input signature
into a CUDA graph and replayed with one launch (:data:`FK_GRAPH` counts
both); anywhere else (the CPU, autograd, ``torch.export``, inside another
capture) the loop runs as it is.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from multihmr_tpu_torch.utils.profiling import span

#: ``_forward_kinematics``'s calls, and the sequential bone compositions
#: they took (one a bone a call: 55 for SMPL-X, 163 for Anny)
FK = {"calls": 0, "steps": 0}
#: the FK's CUDA graphs: captures made (one a key of ``_GRAPHS``) and calls
#: replayed from one
FK_GRAPH = {"captures": 0, "replays": 0}
# (device, stream, dtypes, shape, strides, parents) -> (graph, static rotmats,
# static joints, static outputs)
_GRAPHS: dict = {}
_GRAPHS_LOCK = threading.Lock()

_FLOAT_FIELDS = ("v_template", "shapedirs", "exprdirs", "posedirs",
                 "J_regressor", "lbs_weights", "lmk_bary_coords")
_INDEX_FIELDS = ("extra_joint_vertex_ids", "faces", "lmk_faces_idx")


@dataclasses.dataclass(frozen=True)
class BodyModel:
    """Body-model constants as tensors on one device.

    ``parents`` stays on the host: the kinematic tree drives a Python loop."""

    v_template: torch.Tensor  # [V, 3]
    shapedirs: torch.Tensor  # [V, 3, B]
    exprdirs: torch.Tensor  # [V, 3, E] (E = 0 for SMPL)
    posedirs: torch.Tensor  # [9*(J-1), V*3]
    J_regressor: torch.Tensor  # [J, V]
    lbs_weights: torch.Tensor  # [V, J]
    parents: tuple  # [J] ints, parents[0] == -1
    extra_joint_vertex_ids: torch.Tensor  # [n_extra] int64
    faces: torch.Tensor  # [F, 3] int64
    lmk_faces_idx: torch.Tensor  # [n_lmk] int64
    lmk_bary_coords: torch.Tensor  # [n_lmk, 3]

    @classmethod
    def from_arrays(cls, arrays: dict, device) -> "BodyModel":
        """Build from the numpy dict of :mod:`multihmr_tpu_torch.bodymodel.assets`."""
        kw = {k: torch.as_tensor(np.asarray(arrays[k], np.float32), device=device)
              for k in _FLOAT_FIELDS}
        kw.update({k: torch.as_tensor(np.asarray(arrays[k], np.int64), device=device)
                   for k in _INDEX_FIELDS})
        kw["parents"] = tuple(int(p) for p in arrays["parents"])
        return cls(**kw)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def num_output_joints(self) -> int:
        return (self.num_joints + self.extra_joint_vertex_ids.shape[0]
                + self.lmk_faces_idx.shape[0])


def reset_fk() -> None:
    FK.update(calls=0, steps=0)
    FK_GRAPH.update(captures=0, replays=0)


def _compose(rotmats, joints, parents):
    """The bones one after another: the eager path, and what the graph
    captures."""
    J = rotmats.shape[1]
    world_R, world_t = [None] * J, [None] * J
    for j in range(J):
        p = parents[j]
        if p < 0:
            world_R[j] = rotmats[:, j]
            world_t[j] = joints[:, j]
        else:
            t_j = joints[:, j] - joints[:, p]
            world_R[j] = world_R[p] @ rotmats[:, j]
            world_t[j] = (world_R[p] @ t_j[..., None])[..., 0] + world_t[p]
    Rw = torch.stack(world_R, dim=1)
    posed = torch.stack(world_t, dim=1)
    rel_t = posed - torch.einsum("bjmn,bjn->bjm", Rw, joints)
    return posed, Rw, rel_t


def _graph_engages(rotmats) -> bool:
    """A card, no autograd, no tracer and no capture around the call."""
    return (rotmats.is_cuda and torch.is_inference_mode_enabled()
            and not torch.compiler.is_compiling()
            and not torch.cuda.is_current_stream_capturing())


def _capture(rotmats, joints, parents):
    """Static input buffers laid out as these inputs (dense ones keep their
    strides: cuBLAS rounds a transposed 3 x 3 operand otherwise), and the
    loop over them captured into a graph (warmed up first on the capture's
    side stream)."""
    R = torch.empty_like(rotmats)
    t = torch.empty_like(joints)
    with torch.cuda.device(rotmats.device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _compose(R, t, parents)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            outs = _compose(R, t, parents)
    FK_GRAPH["captures"] += 1
    return graph, R, t, outs


def _replay(rotmats, joints, parents):
    """The loop's outputs from its graph, captured at the first call of this
    key; clones, so that no caller holds what the next replay overwrites."""
    dev = rotmats.device
    key = (dev, torch.cuda.current_stream(dev), rotmats.dtype, joints.dtype, rotmats.shape,
           rotmats.stride(), joints.stride(), parents)
    with _GRAPHS_LOCK:
        entry = _GRAPHS.get(key)
        if entry is None:
            entry = _GRAPHS[key] = _capture(rotmats, joints, parents)
        graph, R, t, outs = entry
        R.copy_(rotmats)
        t.copy_(joints)
        graph.replay()
        FK_GRAPH["replays"] += 1
        return tuple(o.clone() for o in outs)


def _forward_kinematics(rotmats, joints, parents):
    """Compose local rotations ``[B, J, 3, 3]`` along the tree (parents[j] < j).

    Returns (posed joints ``[B, J, 3]``, world rotations ``[B, J, 3, 3]``,
    skinning translations ``[B, J, 3]``) with the skinning transform
    ``A_j = [R_j | posed_j - R_j rest_j]``."""
    with span("fk"):
        if _graph_engages(rotmats):
            posed, Rw, rel_t = _replay(rotmats, joints, parents)
        else:
            posed, Rw, rel_t = _compose(rotmats, joints, parents)
    FK["calls"] += 1
    FK["steps"] += rotmats.shape[1]
    return posed, Rw, rel_t


def lbs_forward(model: BodyModel, rotmats, betas, expression: Optional[torch.Tensor] = None):
    """Body-model forward.

    ``rotmats [B, J, 3, 3]`` (index 0 = global orient), ``betas [B, nb]``
    (nb may be below the asset's count), optional ``expression [B, E]``.
    Returns ``vertices [B, V, 3]``, ``joints [B, J_out, 3]`` (FK joints, then
    vertex keypoints, then face landmarks), ``joints_fk``, ``world_rot`` and
    ``rel_t``."""
    B = rotmats.shape[0]
    nb = betas.shape[-1]
    V = model.num_vertices

    sd = model.shapedirs[..., :nb].reshape(V * 3, nb)
    v_shaped = model.v_template + (betas @ sd.T).reshape(B, V, 3)
    if expression is not None and model.exprdirs.shape[-1] > 0:
        ne = expression.shape[-1]
        ed = model.exprdirs[..., :ne].reshape(V * 3, ne)
        v_shaped = v_shaped + (expression @ ed.T).reshape(B, V, 3)

    joints_rest = torch.einsum("jv,bvc->bjc", model.J_regressor, v_shaped)

    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feature = (rotmats[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(B, -1, 3)

    posed_joints, world_R, rel_t = _forward_kinematics(rotmats, joints_rest, model.parents)

    # blend the 12 transform entries per vertex, then apply them
    A = torch.cat([world_R.reshape(B, -1, 9), rel_t], dim=-1)  # [B, J, 12]
    T = torch.einsum("bjp,vj->bpv", A, model.lbs_weights)  # [B, 12, V]
    vp = v_posed.transpose(1, 2)  # [B, 3, V]
    verts = torch.stack(
        [T[:, 3 * m] * vp[:, 0] + T[:, 3 * m + 1] * vp[:, 1]
         + T[:, 3 * m + 2] * vp[:, 2] + T[:, 9 + m] for m in range(3)],
        dim=-1,
    )

    out_joints = [posed_joints]
    if model.extra_joint_vertex_ids.shape[0] > 0:
        out_joints.append(verts[:, model.extra_joint_vertex_ids])
    if model.lmk_faces_idx.shape[0] > 0:
        lmk_verts = verts[:, model.faces[model.lmk_faces_idx]]  # [B, n_lmk, 3, 3]
        out_joints.append(torch.einsum("blkc,lk->blc", lmk_verts, model.lmk_bary_coords))
    return {
        "vertices": verts,
        "joints": torch.cat(out_joints, dim=1),
        "joints_fk": posed_joints,
        "world_rot": world_R,
        "rel_t": rel_t,
    }


def world_transforms_homogeneous(out: dict):
    """``[B, J, 4, 4]`` world transforms of an :func:`lbs_forward` output:
    ``world_rot`` with the posed joint as translation (the Anny
    ``bone_poses`` layout)."""
    top = torch.cat([out["world_rot"], out["joints_fk"][..., None]], dim=-1)  # [B, J, 3, 4]
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
