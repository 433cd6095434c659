"""Seeded weights, drawn on the device.

``draw(shapes, norms, config, seed, device)`` gives every tensor of the
network by its checkpoint name from one CUDA (or CPU) generator, in three
large calls: fan-in-scaled normals for every matrix, unit normals for the
embeddings, zeros and ones for the biases and LayerNorms, and LayerScale at
``assumed["layerscale"]`` (DINOv2's 1e-5 would leave every block all but
silent, so the comparison could not see the blocks). The regression head's
mean parameters are the identity rotations, zero shape and expression, and
a camera whose log-depth is ``assumed["init_log_depth"]`` with that output
row zeroed, so that every person stands a few metres in front of the camera.
The score head's last layer is scaled by ``assumed["score_gain"]``, so
that the score map has peaks, and its bias placed by the plain reference
(``place_scores``) so that every seed's map holds persons; the head's
decoders are scaled by ``assumed["decoder_gain"]``.

The benchmark hands the same tensors to the program (``load``, through
``load_state_dict(assign=True)`` into a net built on the meta device) and
to the reference (``draw`` again from the seed).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# name suffix -> standard deviation of the unit normal draw
_EMBED_STD = {"cls_token": 0.02, "pos_embed": 0.02, "cross_queries_x": 0.2,
              "cross_queries_y": 0.2, "cross_values_x": 0.2, "cross_values_y": 0.2,
              "pos_embedding": 1.0}


def _kind(name: str, shape, norms: set) -> str:
    leaf = name.rsplit(".", 1)[-1]
    module = name.rsplit(".", 1)[0]
    if leaf == "gamma":
        return "layerscale"
    if module in norms:
        return "one" if leaf == "weight" else "zero"
    if leaf in _EMBED_STD:
        return "embed"
    if leaf.startswith("init_"):
        return "mean"
    if leaf == "bias" or len(shape) < 2:
        return "zero"
    return "matrix"


def _mean(leaf: str, shape, assumed: dict, device) -> torch.Tensor:
    if leaf == "init_body_pose":  # the identity 6-D rotation of every joint
        return torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=device).repeat(shape[-1] // 6)[None]
    t = torch.zeros(shape, device=device)
    if leaf == "init_cam":
        t[0, 0] = assumed["init_log_depth"]
    return t


def net_layout(net) -> tuple[dict, set]:
    """(name → shape, names of the LayerNorm modules) of a network, which may
    live on the meta device."""
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    norms = {n for n, m in net.named_modules() if type(m).__name__.endswith("LayerNorm")}
    return shapes, norms


def draw(shapes: dict, norms: set, config: dict, seed: int, device) -> dict:
    assumed = config["assumed"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    kinds = {k: _kind(k, s, norms) for k, s in shapes.items()}
    out = {}
    for kind in ("matrix", "embed"):
        names = sorted(k for k in shapes if kinds[k] == kind)
        sizes = [int(torch.Size(shapes[k]).numel()) for k in names]
        flat = torch.randn(sum(sizes), generator=g, device=device)
        for k, part in zip(names, flat.split(sizes)):
            scale = (shapes[k][-1] ** -0.5 if kind == "matrix"
                     else _EMBED_STD[k.rsplit(".", 1)[-1]])
            out[k] = part.view(shapes[k]).mul_(scale)
    for k, kind in kinds.items():
        if kind == "one":
            out[k] = torch.ones(shapes[k], device=device)
        elif kind == "zero":
            out[k] = torch.zeros(shapes[k], device=device)
        elif kind == "layerscale":
            out[k] = torch.full(shapes[k], float(assumed["layerscale"]), device=device)
        elif kind == "mean":
            out[k] = _mean(k.rsplit(".", 1)[-1], shapes[k], assumed, device)
    out["x_attention_head.deccam.weight"][0] = 0.0  # the log-depth row: a fixed distance
    # a score map with clear peaks, as a trained one has, rather than one
    # flat within rounding of 0.5 everywhere
    out["mlp_classif.fc1.weight"] *= assumed["score_gain"]
    # the regression decoders start small, as Multi-HMR initializes them
    # (gain 0.01), so that poses stay near the mean pose and 6-D rotations
    # far from their degenerate inputs
    for k in ("pose", "shape", "cam", "expression"):
        out[f"x_attention_head.dec{k}.weight"] *= assumed["decoder_gain"]
    out = {k: out[k] for k in shapes}
    place_scores(config, out, seed, device)
    return out


def place_scores(config: dict, w: dict, seed: int, device) -> float:
    """Shift the score head's last bias so that, on a square frame made from
    the seed, the ``assumed["score_rank"]``-th strongest peak (3 x 3 local
    maximum) of the score map reads ``assumed["score_at"]``. Random weights
    move the whole map by a constant of their own, which left one seed in
    about twelve with no cell over the threshold and so nothing to compare;
    placed so, every seed's images hold persons. The map is the plain
    reference's, in float32 (``reference/model.py``); the shift is returned."""
    from portbench import inputs
    from portbench.reference.model import Reference

    assumed, S = config["assumed"], config["img_size"]
    frame = inputs.frames([[S, S]], 1, seed, device)[0]
    x = torch.as_tensor(inputs.normalize(frame), device=device)
    with torch.no_grad():
        logits = Reference(config, w, None, device).score_logits(x)
    hmax = F.max_pool2d(logits[None, None], 3, stride=1, padding=1)[0, 0]
    peaks = logits[logits == hmax].sort(descending=True).values
    p = assumed["score_at"]
    shift = math.log(p / (1 - p)) - float(peaks[min(assumed["score_rank"], len(peaks)) - 1])
    w["mlp_classif.fc1.bias"] += shift
    return shift


def load(net_cls, cfg, config: dict, seed: int, device):
    """The program's network (``cfg``: the port's configuration of the file
    ``config``) with the seeded weights, built on the meta device and
    assigned in place."""
    with torch.device("meta"):
        net = net_cls(cfg)
    shapes, norms = net_layout(net)
    net.load_state_dict(draw(shapes, norms, config, seed, device), strict=True, assign=True)
    return net, shapes, norms
