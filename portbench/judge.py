"""What decides ``correct``: the program's outputs against the plain reference.

The reference (``reference/``) is built here from the same seed, from
weights and a body model that this module draws anew (``weights.draw``,
``inputs.body_model``), never from the program's state. It then reads the
program's outputs only to judge them:

* the persons an image's answer holds are matched to the grid cells they
  came from (each person's pixel location and score against every cell's
  in the reference);
* ``select_gap``: how far, in logits, the program's choice of cells
  departs from what the reference's scores allow (a chosen cell under the
  threshold or not a local maximum, an unchosen local maximum above the
  threshold while slots were free, or above a chosen one): 0 when the
  choice is the reference's, the clearance of the persons missed when the
  program detects too few or none. Logits, not scores: at the peaks the
  sigmoid is flat, and a score's rounding hides there what its logit shows;
* ``count_err``: the persons the program found against those the
  reference's NMS and top-K find, summed over the sampled images;
* the reference's head then runs on the program's cells (so that a near tie
  between two cells, which rounding may break either way, does not change
  what is compared) and each of the answer's fields is compared with it.

Each field's numbers are its largest error over the sampled images' persons
and its median over them (``Tally``); ``limits/<workload>.json`` names
the ones compared. Training is
compared in ``loops/train.py``.
"""

from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

from portbench import inputs, weights
from portbench.reference.body import rodrigues
from portbench.reference.model import Reference


def reference(cell, control: bool = False, remat: bool = False) -> Reference:
    from multihmr_tpu_torch.models.multihmr import MultiHMRNet

    with torch.device("meta"):
        net = MultiHMRNet(cell.model_config())
    shapes, norms = weights.net_layout(net)
    w = weights.draw(shapes, norms, cell.config, cell.seed, cell.device)
    body = inputs.body_model(cell.config["body_model"], cell.seed)
    return Reference(cell.config, w, body, cell.device, control=control, remat=remat)


def _t(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def logit(p):
    p = torch.as_tensor(p, dtype=torch.float32).clamp(1e-4, 1 - 1e-4)
    return torch.log(p / (1 - p))


def select_gap(scores, rows, cols, thresh: float, capacity: int) -> float:
    """The widest margin by which the chosen cells ``(rows, cols)`` depart
    from a choice that ``scores [g, g]`` (logits, as is ``thresh``) allows:
    a chosen cell below the
    threshold or below a neighbour, or an unchosen strict local maximum
    above the threshold while a slot was free, or above a chosen cell. An
    unchosen maximum counts only by its own margin over its neighbours, so
    two cells within rounding of each other may go either way."""
    pad = F.pad(scores[None, None], (1, 1, 1, 1), value=float("-inf"))
    nbrs = F.unfold(pad, 3)[0].reshape(9, *scores.shape)
    margin = scores - torch.cat([nbrs[:4], nbrs[5:]]).amax(0)  # > 0: a strict local max
    chosen = torch.zeros_like(scores, dtype=torch.bool)
    chosen[rows, cols] = True
    gap = 0.0
    if len(rows):
        s = scores[rows, cols]
        gap = max(gap, float((thresh - s).max()), float((-margin[rows, cols]).max()))
    free = (margin > 0) & ~chosen & (scores >= thresh)
    if free.any():
        m, s = margin[free], scores[free]
        if len(rows) < capacity:
            gap = max(gap, float(torch.minimum(m, s - thresh).max()))
        if len(rows):
            low = float(scores[rows, cols].min())
            gap = max(gap, float(torch.minimum(m, s - low).max()))
    return max(gap, 0.0)


class Tally:
    """Per-person errors of each field over the sampled images: ``numbers()``
    gives each field's largest (``<field>``) and its median over the persons
    (``<field>_p50``); gaps give their largest alone, counts their sum."""

    def __init__(self):
        self.per_person, self.worst, self.sums = {}, {}, {}

    def person(self, name, values):
        self.per_person.setdefault(name, []).extend(float(v) for v in values)

    def largest(self, name, value):
        self.worst[name] = max(self.worst.get(name, 0.0), float(value))

    def total(self, name, value):
        self.sums[name] = self.sums.get(name, 0.0) + float(value)

    def numbers(self) -> dict:
        out = dict(self.worst, **self.sums)
        for k, v in self.per_person.items():
            out[k] = max(v)
            out[k + "_p50"] = statistics.median(v)
        return out


def _per_person(a, b):
    """The largest absolute difference of each person's elements."""
    return (a - b).abs().reshape(a.shape[0], -1).amax(1).tolist()


def judge_image(ref: Reference, x, K, persons: list, tally: Tally) -> None:
    """Fold one image's comparison into ``tally``. ``x``: the normalized
    ``[S, S, 3]`` image; ``persons``: dicts holding at least ``scores`` (or
    ``score``) and ``loc``, and whichever of ``transl``, ``transl_pelvis``,
    ``rotvec`` (or ``rotmat``), ``shape`` and ``expression``, ``v3d`` and
    ``j3d`` the answer gives."""
    dev, c = ref.device, ref.cfg
    K = _t(K, dev)
    with torch.no_grad():
        f = ref.features(_t(x, dev), K)
        g = ref.g
        score = lambda p: float(p["scores"] if "scores" in p else p["score"])  # noqa: E731
        cells = []
        for p in persons:
            cost = ((f["loc"] - _t(p["loc"], dev)).norm(dim=-1) / c["patch_size"]
                    + (f["scores"] - score(p)).abs())
            cells.append(int(cost.argmin()))
        idx = torch.tensor(cells, dtype=torch.long, device=dev)
        rows, cols = idx // g, idx % g
        tally.largest("select_gap", select_gap(f["logits"], rows, cols,
                                               float(logit(c["det_thresh"])), c["max_people"]))
        tally.largest("persons_err", len(cells) - len(set(cells)))  # two answers, one cell
        tally.total("count_err", abs(len(cells) - len(ref.detect(f["scores"])[0])))
        if not persons:
            return
        r = ref.head(f, rows, cols, K)
        get = lambda k: torch.stack([_t(p[k], dev) for p in persons])  # noqa: E731
        tally.person("logit_err", _per_person(
            logit([score(p) for p in persons]).to(dev)[:, None], logit(r["scores"])[:, None]))
        tally.person("loc_err", _per_person(get("loc"), r["loc"]))
        if "transl" in persons[0]:
            tally.person("transl_err", _per_person(get("transl"), r["transl"]))
        if "transl_pelvis" in persons[0]:
            tally.person("pelvis_err", _per_person(get("transl_pelvis").reshape(-1, 3),
                                                   r["transl_pelvis"].reshape(-1, 3)))
        if "rotvec" in persons[0]:
            tally.person("rot_err", _per_person(rodrigues(get("rotvec")), r["rotmat"]))
        elif "rotmat" in persons[0]:
            tally.person("rot_err", _per_person(get("rotmat"), r["rotmat"]))
        if "shape" in persons[0]:
            tally.person("shape_err", _per_person(
                torch.cat([get("shape"), get("expression")], -1),
                torch.cat([r["shape"], r["expression"]], -1)))
        if "v3d" in persons[0]:
            t_p, t_r = get("transl")[:, None], r["transl"][:, None]
            tally.person("mesh_err", _per_person(
                torch.cat([get("v3d"), get("j3d")], 1) - t_p,
                torch.cat([r["v3d"], r["j3d"]], 1) - t_r))


PERSON_KEYS = ("scores", "loc", "transl", "transl_pelvis", "rotmat", "shape", "expression",
               "v3d", "j3d")


def control_persons(ctrl: Reference, x, K, keys=PERSON_KEYS) -> list:
    """The control in the program's place: its own detections and head on
    one image, as person dicts of ``keys``."""
    dev = ctrl.device
    K = _t(K, dev)
    with torch.no_grad():
        f = ctrl.features(_t(x, dev), K)
        rows, cols = ctrl.detect(f["scores"])
        if not len(rows):
            return []
        r = ctrl.head(f, rows, cols, K)
    host = {k: r[k].float().cpu().numpy() for k in keys}
    return [{k: host[k][i] for k in keys} for i in range(len(rows))]
