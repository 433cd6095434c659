"""Anny phenotype body model (``multihmr_tpu/bodymodel/anny.py``).

The second model family's body: 163 bones, linear blend skinning, and
*phenotype* controls (age, gender, weight, height, muscle, proportions in
[0, 1]) that map to blendshape coefficients. The mapping is stored as a
multilinear lattice: per-phenotype knot positions and the coefficients at
every knot combination, interpolated over the 2^6 surrounding corners.
Everything downstream (blendshapes, FK, LBS) is ``bodymodel/core.py``.

Assets are numpy dicts, as in ``bodymodel/assets.py``: the
:class:`~multihmr_tpu_torch.bodymodel.core.BodyModel` fields plus
``pheno_knots``, ``pheno_lattice``, ``bone_labels`` and
``phenotype_labels``; :meth:`AnnyModel.from_arrays` puts them on a device.
``tools/convert_anny.py`` writes the ``.npz`` container
:func:`load_anny_npz` reads (either package's file loads in the other);
:func:`synthetic_anny_model` is the structure-identical stand-in, equal to
the JAX package's for one seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.bodymodel.core import (
    BodyModel,
    lbs_forward,
    world_transforms_homogeneous,
)

# Phenotypes the network regresses, picked out of its shape vector by name
# in the asset's ``phenotype_labels`` order.
USED_PHENOTYPES = ("age", "gender", "weight", "height", "muscle", "proportions")
# Default labels of the synthetic stand-in (a real asset carries its own).
PHENOTYPE_LABELS = (
    "age", "gender", "weight", "height", "muscle", "proportions", "race",
    "cup_size", "firmness", "asymmetry",
)
NUM_BONES = 163


@dataclasses.dataclass(frozen=True)
class AnnyModel:
    """A BodyModel skeleton (its shapedirs are the blendshape targets) and the
    lattice phenotype mapping, as tensors on one device.

    ``pheno_knots [n_used, n_knots]`` are sorted knot positions in [0, 1] per
    used phenotype; ``pheno_lattice [n_knots**n_used, n_blend]`` holds the
    coefficients at every knot combination (row-major, last phenotype
    fastest)."""

    base: BodyModel
    pheno_knots: torch.Tensor
    pheno_lattice: torch.Tensor
    bone_labels: Tuple[str, ...] = tuple(f"bone_{i:03d}" for i in range(NUM_BONES))
    phenotype_labels: Tuple[str, ...] = PHENOTYPE_LABELS

    @classmethod
    def from_arrays(cls, arrays: dict, device) -> "AnnyModel":
        """Build from a numpy dict of :func:`synthetic_anny_model` or
        :func:`load_anny_npz`."""
        f32 = lambda k: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(arrays[k], np.float32), device=device)
        return cls(
            base=BodyModel.from_arrays(arrays, device),
            pheno_knots=f32("pheno_knots"),
            pheno_lattice=f32("pheno_lattice"),
            bone_labels=tuple(str(s) for s in arrays["bone_labels"]),
            phenotype_labels=tuple(str(s) for s in arrays["phenotype_labels"]),
        )

    @property
    def num_knots(self) -> int:
        return self.pheno_knots.shape[1]

    # the demo reads these of any body model
    @property
    def faces(self) -> torch.Tensor:
        return self.base.faces

    @property
    def v_template(self) -> torch.Tensor:
        return self.base.v_template

    @property
    def num_vertices(self) -> int:
        return self.base.num_vertices

    def person_center_index(self, name: str) -> int:
        """A bone's index by its label."""
        return self.bone_labels.index(name)

    def used_phenotype_indices(self) -> list:
        """Position of each used phenotype in the asset's shape vector."""
        return [self.phenotype_labels.index(n) for n in USED_PHENOTYPES]


def phenotype_to_coeffs(model: AnnyModel, phenotypes: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Multilinear lattice interpolation: phenotypes (each ``[B]`` in [0, 1])
    → blendshape coefficients ``[B, n_blend]``, summed over the 2^n_used
    corners of the knot cell each phenotype vector falls in (corner bits
    most significant first, as the JAX package orders them)."""
    n_used = len(USED_PHENOTYPES)
    nk = model.num_knots
    knots = model.pheno_knots  # [n_used, nk], sorted per row
    p = torch.stack([phenotypes[n] for n in USED_PHENOTYPES], dim=0)  # [n_used, B]
    p = torch.clamp(p, knots[:, :1], knots[:, -1:])
    lo = torch.clamp(torch.searchsorted(knots, p.contiguous(), right=True) - 1, 0, nk - 2)
    k_lo = torch.gather(knots, 1, lo)
    k_hi = torch.gather(knots, 1, lo + 1)
    t = ((p - k_lo) / torch.clamp(k_hi - k_lo, min=1e-12)).T  # [B, n_used]

    dev = p.device
    shifts = torch.arange(n_used - 1, -1, -1, device=dev)
    bits = (torch.arange(2 ** n_used, device=dev)[:, None] >> shifts) & 1  # [corners, n_used]
    idx = ((lo.T[:, None, :] + bits) * nk ** shifts).sum(-1)  # [B, corners], row-major
    wd = torch.where(bits.bool(), t[:, None, :], 1.0 - t[:, None, :])  # [B, corners, n_used]
    w = wd[..., 0]
    for d in range(1, n_used):  # the JAX package's product order
        w = w * wd[..., d]
    return (model.pheno_lattice[idx] * w[..., None]).sum(1)


def anny_forward(model: AnnyModel, pose_matrices, phenotypes: Dict[str, torch.Tensor]) -> dict:
    """``pose_matrices [B, J, 4, 4]`` homogeneous per-bone rotations and the
    phenotypes (each ``[B]``) → ``vertices``, ``bone_poses`` (homogeneous
    world transforms, translation = joint), ``joints`` and
    ``blendshape_coeffs``."""
    coeffs = phenotype_to_coeffs(model, phenotypes)
    out = lbs_forward(model.base, pose_matrices[..., :3, :3],
                      coeffs[:, : model.base.shapedirs.shape[-1]])
    return {
        "vertices": out["vertices"],
        "bone_poses": world_transforms_homogeneous(out),
        "joints": out["joints_fk"],
        "blendshape_coeffs": coeffs,
    }


def anny_arrays(v_template, shapedirs, J_regressor, lbs_weights, parents, faces,
                pheno_knots, pheno_lattice, bone_labels, phenotype_labels) -> dict:
    """An asset dict from the fields an Anny container stores; the rest as the
    JAX package's loader fills them: no expressions, vertex keypoints or
    landmarks, and zero pose correctives ``[9 (J - 1), 3 V]``."""
    V, J = np.asarray(v_template).shape[0], np.asarray(parents).shape[0]
    return {
        "v_template": np.asarray(v_template, np.float32),
        "shapedirs": np.asarray(shapedirs, np.float32),
        "exprdirs": np.zeros((V, 3, 0), np.float32),
        "posedirs": np.zeros((9 * (J - 1), 3 * V), np.float32),
        "J_regressor": np.asarray(J_regressor, np.float32),
        "lbs_weights": np.asarray(lbs_weights, np.float32),
        "parents": np.asarray(parents, np.int32),
        "extra_joint_vertex_ids": np.zeros((0,), np.int32),
        "faces": np.asarray(faces, np.int32).reshape(-1, 3),
        "lmk_faces_idx": np.zeros((0,), np.int32),
        "lmk_bary_coords": np.zeros((0, 3), np.float32),
        "pheno_knots": np.asarray(pheno_knots, np.float32),
        "pheno_lattice": np.asarray(pheno_lattice, np.float32),
        "bone_labels": tuple(str(s) for s in bone_labels),
        "phenotype_labels": tuple(str(s) for s in phenotype_labels),
    }


def synthetic_anny_model(num_vertices: int = 256, num_bones: int = NUM_BONES, n_blend: int = 20,
                         num_knots: int = 3, seed: int = 1) -> dict:
    """Structure-identical random stand-in for the licensed asset."""
    arrays = synthetic_body_model(num_vertices=num_vertices, num_joints=num_bones,
                                  num_betas=n_blend, num_expression=0, num_extra=0,
                                  num_lmk=0, seed=seed)
    rng = np.random.default_rng(seed)
    n_used = len(USED_PHENOTYPES)
    knots = np.broadcast_to(np.linspace(0.0, 1.0, num_knots), (n_used, num_knots))
    lattice = rng.normal(scale=0.3, size=(num_knots ** n_used, n_blend))
    # synthetic bone labels, with the names the model resolves
    labels = [f"bone_{i:03d}" for i in range(num_bones)]
    if num_bones > 16:
        labels[0], labels[15] = "root", "head"
    arrays.update(pheno_knots=np.array(knots, np.float32),
                  pheno_lattice=np.asarray(lattice, np.float32),
                  bone_labels=tuple(labels), phenotype_labels=PHENOTYPE_LABELS)
    return arrays


def load_anny_npz(path: str) -> dict:
    """A converted Anny asset (``tools/convert_anny.py``) as an asset dict."""
    data = np.load(path, allow_pickle=False)
    return anny_arrays(
        data["v_template"], data["shapedirs"], data["J_regressor"], data["lbs_weights"],
        data["parents"], data["faces"] if "faces" in data else np.zeros((0, 3)),
        data["pheno_knots"], data["pheno_lattice"], data["bone_labels"],
        data["phenotype_labels"])


def save_anny_npz(path: str, model: AnnyModel) -> None:
    """Inverse of :func:`load_anny_npz`, in the JAX package's layout."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    b = model.base
    np.savez_compressed(
        path,
        v_template=host(b.v_template),
        shapedirs=host(b.shapedirs),
        J_regressor=host(b.J_regressor),
        lbs_weights=host(b.lbs_weights),
        parents=np.asarray(b.parents, np.int32),
        faces=host(b.faces).astype(np.int32),
        pheno_knots=host(model.pheno_knots),
        pheno_lattice=host(model.pheno_lattice),
        bone_labels=np.asarray(list(model.bone_labels)),
        phenotype_labels=np.asarray(list(model.phenotype_labels)),
    )
