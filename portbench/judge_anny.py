"""What decides ``correct`` in the Anny family's cells: the program's
persons against the plain reference (``reference/anny.py``).

As ``judge.py`` does for the SMPL-X family: the reference is built from the
seed, from weights and an asset drawn anew (``weights_anny``), never from
the program's state, and it reads the program's answers only to judge
them. An answer's persons carry no score, so each is matched to the cell
whose centre is nearest its ``loc`` (the seeded offsets are a small part of
a patch); ``select_gap`` and ``persons_err`` then judge the choice of
cells, and the reference's decoder, heads and body model run on the
program's cells. Its fields, each by its largest error over the sampled
images' persons and its median (``judge.Tally``):

* ``loc_err`` (pixels), ``transl_err`` (m, from the distance head);
* ``rot_err``: the 163 bone rotations, pinned ones included;
* ``shape_err``: the 11 phenotypes;
* ``mesh_err`` (m): vertices and bone heads less ``transl``;
* ``fov_err`` (radians): the regressed field of view, once an image.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import weights_anny
from portbench.judge import Tally, _per_person, _t, logit, select_gap
from portbench.reference.anny import AnnyReference


def model_config(c: dict):
    """The port's ``AnnyConfig`` of a configuration file, which must give the
    sizes of the port's ``factory.anny_config`` for its name."""
    from multihmr_tpu_torch.config import ViTConfig
    from multihmr_tpu_torch.factory import anny_config
    from multihmr_tpu_torch.models.multihmr_anny import AnnyConfig

    vit = ViTConfig(embed_dim=c["embed_dim"], depth=c["depth"], num_heads=c["num_heads"],
                    patch_size=c["patch_size"], mlp_ratio=c["mlp_ratio"])
    cfg = AnnyConfig(backbone=c["backbone"], img_size=c["img_size"], xat_dim=c["xat_dim"],
                     xat_depth=c["xat_depth"], xat_heads=c["xat_heads"],
                     xat_dim_head=c["xat_dim_head"], xat_mlp_dim=c["xat_mlp_dim"],
                     person_center=c["person_center"], num_betas=c["num_betas"],
                     n_joints=c["n_joints"], max_people=c["max_people"],
                     compute_dtype=c["compute_dtype"], vit_override=vit)
    named = anny_config(c["name"])
    if (dataclasses.replace(cfg, vit_override=None) != dataclasses.replace(named,
                                                                           vit_override=None)
            or dataclasses.astuple(named.vit)[:5] != dataclasses.astuple(vit)[:5]
            or c["param_dtype"] != "float32"):
        raise ValueError(f"configs/{c['name']}.json differs from the port's anny_config")
    return named


def reference(cell, control: bool = False) -> AnnyReference:
    from multihmr_tpu_torch.models.multihmr_anny import MultiHMRAnnyNet

    with torch.device("meta"):
        net = MultiHMRAnnyNet(model_config(cell.config))
    shapes, norms = weights_anny.net_layout(net)
    w = weights_anny.draw(shapes, norms, cell.config, cell.seed, cell.device)
    body = weights_anny.asset(cell.config["body_model"], cell.seed)
    return AnnyReference(cell.config, w, body, cell.device, control=control)


def judge_image(ref: AnnyReference, x, K, persons: list, tally: Tally) -> None:
    """Fold one image's comparison into ``tally``. ``x``: the normalized
    ``[S, S, 3]`` image; ``persons``: dicts holding ``loc``, ``transl``,
    ``rotmat``, ``shape``, ``v3d``, ``j3d`` and ``fov``."""
    dev, c, g, p = ref.device, ref.cfg, ref.g, ref.cfg["patch_size"]
    K = _t(K, dev)
    with torch.no_grad():
        f = ref.features(_t(x, dev))
        ar = (torch.arange(g, device=dev, dtype=torch.float32) + 0.5) * p
        centres = torch.stack(torch.meshgrid(ar, ar, indexing="xy"), -1).reshape(-1, 2)
        cells = [int((centres - _t(q["loc"], dev)).norm(dim=-1).argmin()) for q in persons]
        idx = torch.tensor(cells, dtype=torch.long, device=dev)
        rows, cols = idx // g, idx % g
        tally.largest("select_gap", select_gap(f["logits"], rows, cols,
                                               float(logit(c["det_thresh"])), c["max_people"]))
        tally.largest("persons_err", len(cells) - len(set(cells)))  # two answers, one cell
        tally.total("count_err", abs(len(cells) - len(ref.detect(f["scores"])[0])))
        if not persons:
            return
        r = ref.head(f, rows, cols, K)
        get = lambda k: torch.stack([_t(q[k], dev) for q in persons])  # noqa: E731
        tally.person("loc_err", _per_person(get("loc"), r["loc"]))
        tally.person("transl_err", _per_person(get("transl"), r["transl"]))
        tally.person("rot_err", _per_person(get("rotmat"), r["rotmat"]))
        tally.person("shape_err", _per_person(get("shape"), r["shape"]))
        tally.person("mesh_err", _per_person(
            torch.cat([get("v3d"), get("j3d")], 1) - get("transl")[:, None],
            torch.cat([r["v3d"], r["j3d"]], 1) - r["transl"][:, None]))
        tally.person("fov_err", [abs(float(persons[0]["fov"].reshape(-1)[0]) - float(r["fov"]))])


PERSON_KEYS = ("loc", "transl", "rotmat", "shape", "v3d", "j3d", "fov")


def control_persons(ctrl: AnnyReference, x, K, keys=PERSON_KEYS) -> list:
    """The control in the program's place: its own detections and head on
    one image, as person dicts of ``keys``."""
    dev = ctrl.device
    K = _t(K, dev)
    with torch.no_grad():
        f = ctrl.features(_t(x, dev))
        rows, cols = ctrl.detect(f["scores"])
        if not len(rows):
            return []
        r = ctrl.head(f, rows, cols, K)
    host = {k: r[k].float().cpu().numpy() for k in keys}
    return [{k: host[k] if k == "fov" else host[k][i] for k in keys} for i in range(len(rows))]
