"""Seeded weights for Multi-HMR on DINOv2's ViT-g/14, drawn on the device.

``draw(shapes, norms, config, seed, device)`` gives every tensor of the
network by its checkpoint name as ``weights.py`` does for the GELU
backbones, from one generator in the same order and with the same kinds:
fan-in-scaled normals for every matrix (the SwiGLU's ``w12`` and ``w3``
among them), unit normals for the embeddings, ones and zeros for the
LayerNorms and the other biases, LayerScale at ``assumed["layerscale"]``,
the head's mean parameters, the fixed distance, and the score and decoder
gains. Then, as ``assumed`` states:

* the SwiGLU's biases (``mlp.w12.bias``, ``mlp.w3.bias``) are normals of
  standard deviation ``assumed["ffn_bias_std"]``, drawn after the rest,
  so that the comparison sees them (zero biases would let an FFN that
  drops one, or adds one to the wrong half, pass);
* the score head's last bias is placed per seed by the plain reference of
  this backbone (``reference/vitg.py``, ``place_scores``), as
  ``weights.place_scores`` places it with the GELU reference, but on
  frames of the sizes ``assumed["score_frames"]`` contain-padded into the
  square as the folder loops pad theirs, not on one square frame: with
  40 blocks the pad shifts the whole map, and placed on a square frame
  one seed in about twenty left the padded frames with no person.

The benchmark hands the same tensors to the program (``load``) and, drawn
anew, to the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.reference.vitg import VitgReference
from portbench.weights import _EMBED_STD, _kind, _mean, net_layout

FFN_BIASES = (".mlp.w12.bias", ".mlp.w3.bias")


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
    names = sorted(k for k in shapes if k.endswith(FFN_BIASES))
    sizes = [int(torch.Size(shapes[k]).numel()) for k in names]
    flat = torch.randn(sum(sizes), generator=g, device=device) * assumed["ffn_bias_std"]
    for k, part in zip(names, flat.split(sizes)):
        out[k] = part.view(shapes[k])
    out["x_attention_head.deccam.weight"][0] = 0.0  # the log-depth row: a fixed distance
    out["mlp_classif.fc1.weight"] *= assumed["score_gain"]
    for k in ("pose", "shape", "cam", "expression"):
        out[f"x_attention_head.dec{k}.weight"] *= assumed["decoder_gain"]
    out = {k: out[k] for k in shapes}
    place_scores(config, out, seed, device)
    return out


def place_scores(config: dict, w: dict, seed: int, device) -> float:
    """Shift the score head's last bias so that, on each frame of the sizes
    ``assumed["score_frames"]`` made from the seed and contain-padded into
    the square, the ``assumed["score_rank"]``-th strongest peak (3 x 3 local
    maximum) of the plain reference's float32 score map reads at least
    ``assumed["score_at"]`` (on the weakest frame exactly); the shift is
    returned."""
    assumed, S = config["assumed"], config["img_size"]
    ref = VitgReference(config, w, None, device)
    p = assumed["score_at"]
    shift = -math.inf
    for frame in inputs.frames(assumed["score_frames"], 1, seed, device):
        x = torch.as_tensor(inputs.normalize(inputs.contain_pad(frame, S)), device=device)
        with torch.no_grad():
            logits = ref.score_logits(x)
        hmax = F.max_pool2d(logits[None, None], 3, stride=1, padding=1)[0, 0]
        peaks = logits[logits == hmax].sort(descending=True).values
        peak = float(peaks[min(assumed["score_rank"], len(peaks)) - 1])
        shift = max(shift, math.log(p / (1 - p)) - peak)
    w["mlp_classif.fc1.bias"] += shift
    return shift


def layout(net_cls, cfg) -> tuple[dict, set]:
    """(name → shape, LayerNorm module names) of ``net_cls(cfg)``, built on
    the meta device."""
    with torch.device("meta"):
        return net_layout(net_cls(cfg))


def load(net_cls, cfg, config: dict, seed: int, device):
    """The program's network (``cfg``: the port's configuration of the file
    ``config``) with the seeded weights, built on the meta device and
    assigned in place."""
    with torch.device("meta"):
        net = net_cls(cfg)
    shapes, norms = net_layout(net)
    net.load_state_dict(draw(shapes, norms, config, seed, device), strict=True, assign=True)
    return net
