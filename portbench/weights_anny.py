"""Seeded weights and a synthetic body asset for the Anny family, made on
the device (the weights) or the host (the asset) from the seed.

``draw(shapes, norms, config, seed, device)`` gives every tensor of the
network by its checkpoint name as ``weights.py`` does for the SMPL-X
family: fan-in-scaled normals for every matrix, unit normals for the
embeddings, zeros and ones for the biases and LayerNorms, LayerScale at
``assumed["layerscale"]``. Then, as ``assumed`` states:

* ``dec_pos_emb`` and ``init_body_pose``, which a checkpoint carries, are
  their computed values (``reference/anny.py``), not drawn;
* the last layers of the offset, pose, phenotype and distance heads are
  scaled by ``decoder_gain``, so that every person stays near the mean
  pose and the phenotypes near 0.5;
* the distance head's last bias is ``log(focal / distance_m)``, so that
  the persons stand about ``distance_m`` in front of a camera of the
  configuration's field of view (``focal / exp(0)`` would put them near
  580 m at 672 px);
* the detection head's last layer is scaled by ``score_gain`` and its bias
  placed per seed (``place_scores``) so that the ``score_rank``-th peak
  of a seeded frame's map reads ``score_at``: every image fills its
  ``max_people`` slots.

``asset(sizes, seed)`` is a synthetic Anny asset in the layout of a
converted one: ``num_bones`` bones in a branching tree (the root labelled
``root``, bone 15 ``head``), ``num_vertices`` vertices around them with
distance-based skinning weights and joint regressor, ``num_blendshapes``
smooth blendshapes, no pose correctives, and a phenotype lattice of
``num_knots`` knots a phenotype over the six phenotypes the model uses.
The benchmark hands the same weights and asset to the program and, drawn
anew, to the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.reference.anny import USED_PHENOTYPES, AnnyReference, init_pose, pos_embed_2d
from portbench.weights import _EMBED_STD, _kind, net_layout

HEADS = ("mlp_offset", "mlp_pose", "mlp_shape", "mlp_dist")


def draw(shapes: dict, norms: set, config: dict, seed: int, device) -> dict:
    assumed = config["assumed"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    grid = config["img_size"] // config["patch_size"]
    out = {"dec_pos_emb": pos_embed_2d(config["xat_dim"], grid).to(device),
           "init_body_pose": init_pose(config["n_joints"]).to(device)}
    kinds = {k: _kind(k, s, norms) for k, s in shapes.items() if k not in out}
    for kind in ("matrix", "embed"):
        names = sorted(k for k in kinds if kinds[k] == kind)
        sizes = [int(torch.Size(shapes[k]).numel()) for k in names]
        flat = torch.randn(sum(sizes), generator=g, device=device)
        for k, part in zip(names, flat.split(sizes)):
            scale = (shapes[k][-1] ** -0.5 if kind == "matrix"
                     else _EMBED_STD[k.rsplit(".", 1)[-1]])
            out[k] = part.view(shapes[k]).mul_(scale)
    for k, kind in kinds.items():
        if kind in ("one", "zero"):
            out[k] = (torch.ones if kind == "one" else torch.zeros)(shapes[k], device=device)
        elif kind == "layerscale":
            out[k] = torch.full(shapes[k], float(assumed["layerscale"]), device=device)
        elif kind not in ("matrix", "embed"):
            raise ValueError(f"{k}: no seeded value for a {kind!r} tensor")
    for k in HEADS:
        out[f"{k}.fc1.weight"] *= assumed["decoder_gain"]
    focal = float(inputs.camera_K(config["img_size"], config["fov"])[0, 0])
    out["mlp_dist.fc1.bias"].fill_(math.log(focal / assumed["distance_m"]))
    out["encoder.mlp_det.fc1.weight"] *= assumed["score_gain"]
    out = {k: out[k] for k in shapes}
    place_scores(config, out, seed, device)
    return out


def place_scores(config: dict, w: dict, seed: int, device) -> float:
    """Shift the detection head's last bias so that, on a square frame made
    from the seed, the ``assumed["score_rank"]``-th strongest peak (3 x 3
    local maximum) of the plain reference's float32 score map reads
    ``assumed["score_at"]``; the shift is returned."""
    assumed, S = config["assumed"], config["img_size"]
    frame = inputs.frames([[S, S]], 1, seed, device)[0]
    x = torch.as_tensor(inputs.normalize(frame), device=device)
    with torch.no_grad():
        logits = AnnyReference(config, w, None, device).score_logits(x)
    hmax = F.max_pool2d(logits[None, None], 3, stride=1, padding=1)[0, 0]
    peaks = logits[logits == hmax].sort(descending=True).values
    p = assumed["score_at"]
    shift = math.log(p / (1 - p)) - float(peaks[min(assumed["score_rank"], len(peaks)) - 1])
    w["encoder.mlp_det.fc1.bias"] += shift
    return shift


def load(net_cls, cfg, config: dict, seed: int, device):
    """The program's network (``cfg``: its configuration of the file
    ``config``) with the seeded weights, built on the meta device, assigned
    in place, and moved with its buffers outside the state dict."""
    with torch.device("meta"):
        net = net_cls(cfg)
    shapes, norms = net_layout(net)
    net.load_state_dict(draw(shapes, norms, config, seed, device), strict=True, assign=True)
    return net.to(device)


def asset(sizes: dict, seed: int) -> dict:
    """The synthetic Anny asset of ``sizes`` (the configuration's
    ``body_model``) as numpy arrays."""
    V, J, nb, nk = (sizes[k] for k in ("num_vertices", "num_bones", "num_blendshapes",
                                       "num_knots"))
    rng = np.random.default_rng(seed)
    parents = np.array([-1] + [(j - 1) if j % 3 else max(0, j - 3) for j in range(1, J)])
    bones = np.cumsum(rng.normal(scale=0.05, size=(J, 3)), axis=0)
    bones[0] = 0.0
    v = bones[rng.integers(0, J, size=V)] + rng.normal(scale=0.04, size=(V, 3))
    d2 = ((v[:, None] - bones[None]) ** 2).sum(-1)  # each row and column shifted to its
    w = np.exp(-(d2 - d2.min(1, keepdims=True)) / 0.005)  # least, so no sum underflows
    jr = np.exp(-(d2.T - d2.min(0)[:, None]) / 0.002)
    order = np.lexsort((v[:, 2], v[:, 1], v[:, 0]))
    k = np.arange(3 * V)
    labels = [f"bone_{i:03d}" for i in range(J)]
    labels[0], labels[15] = "root", "head"
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "v_template": f32(v),
        "shapedirs": f32(rng.standard_normal((V, 3, nb), np.float32) * 0.01),
        "exprdirs": np.zeros((V, 3, 0), np.float32),
        "posedirs": np.zeros((9 * (J - 1), 3 * V), np.float32),
        "J_regressor": f32(jr / jr.sum(-1, keepdims=True)),
        "lbs_weights": f32(w / w.sum(-1, keepdims=True)),
        "parents": parents.astype(np.int32),
        "extra_joint_vertex_ids": np.zeros((0,), np.int32),
        "faces": np.stack([order[k % V], order[(k + 1) % V], order[(k + 2) % V]], 1).astype(
            np.int32),
        "lmk_faces_idx": np.zeros((0,), np.int32),
        "lmk_bary_coords": np.zeros((0, 3), np.float32),
        "pheno_knots": f32(np.tile(np.linspace(0.0, 1.0, nk), (len(USED_PHENOTYPES), 1))),
        "pheno_lattice": f32(rng.normal(scale=0.3, size=(nk ** len(USED_PHENOTYPES), nb))),
        "bone_labels": tuple(labels),
        "phenotype_labels": tuple(sizes["phenotype_labels"]),
    }
