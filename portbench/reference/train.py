"""Plain reference of a training step: targets, loss, gradients and Adam.

``targets`` builds what a batch's raw SMPL-X parameters imply (the body
model posed with them, placed by their translation and projected; the
cell of each person's head and its offset; log-depth of the pelvis scaled
by focal length; a later person on an earlier one's cell dropped). ``loss``
is the CenterNet focal loss on the score map plus L1 terms over the valid
persons (offset, rotation matrices, shape, log-depth, translation,
pelvis-centred joints and vertices), each a sum over the batch divided by
the batch's count, with the weights of the training recipe; the 2-D terms
join only from epoch 10, so a run from epoch 0 leaves them out. ``steps``
runs forward, backward and Adam (``m / (sqrt(v) + eps)`` on bias-corrected
moments) over the weights, image by image with the batch's counts so that
ViT-L at 896 px fits, each ViT block recomputed in the backward pass.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.body import HEAD_JOINT, project, rodrigues
from portbench.reference.model import Reference, focal_from_fov

WEIGHTS = {"bce": 10.0, "offset": 1.0, "rotmat": 0.1, "shape": 1.0, "dist": 1.0,
           "transl": 1.0, "j3d": 100.0, "v3d": 100.0}


@torch.no_grad()
def targets(ref: Reference, batch: dict) -> list:
    """Per image: the valid persons' cells and targets, and the score map."""
    c, g, p = ref.cfg, ref.g, ref.cfg["patch_size"]
    out = []
    for b in range(batch["image"].shape[0]):
        K = batch["K"][b]
        valid = batch["gt_valid"][b] > 0
        pose, shape, transl = (batch[k][b][valid] for k in ("gt_pose", "gt_shape", "gt_transl"))
        n = pose.shape[0]
        rot = rodrigues(pose)
        eye = torch.eye(3, device=rot.device).expand(n, 2, 3, 3)
        local = torch.cat([rot[:, :22], rot[:, 52:53], eye, rot[:, 22:37], rot[:, 37:52]], 1)
        verts, joints = ref.body.lbs(local, shape, None, ref.P)
        verts, joints = verts + transl[:, None], joints + transl[:, None]
        Kn = K.expand(n, 3, 3)
        centre = joints[:, HEAD_JOINT]
        loc = project(centre[:, None], Kn, ref.P)[:, 0]
        cell = torch.clamp(torch.floor(loc / p).long(), 0, g - 1)
        flat = cell[:, 1] * g + cell[:, 0]
        keep = torch.tensor([not bool((flat[:i] == flat[i]).any()) for i in range(n)],
                            dtype=torch.bool, device=flat.device)
        heat = torch.zeros(g * g, device=flat.device)
        heat[flat[keep]] = 1.0
        depth = torch.log(joints[:, 0, 2] + 1e-10) * (focal_from_fov(c["fovn"], c["img_size"])
                                                     / K[0, 0])
        t = {"rows": cell[:, 1], "cols": cell[:, 0], "offset": (loc - (cell + 0.5) * p) / p,
             "rotmat": rot, "shape": shape, "dist": depth, "transl": centre,
             "pelvis": joints[:, :1], "j3d": joints, "v3d": verts}
        out.append({"heat": heat.reshape(g, g),
                    **{k: v[keep] for k, v in t.items()}})
    return out


def image_loss(ref: Reference, x, K, t: dict, counts: dict):
    """One image's share of the batch's total loss, and of each of its
    terms (unweighted)."""
    f = ref.features(x, K)
    s, heat = f["scores"], t["heat"]
    pos = -(torch.log(s + 1e-7) * (1 - s) ** 2 * heat).sum()
    neg = -(torch.log(1 - s + 1e-7) * s ** 2 * (1 - heat) ** 4 * (heat < 1)).sum()
    terms = {"bce": (pos + neg) / max(counts["pos"], 1.0) if counts["pos"] else neg}
    nv = max(counts["valid"], 1.0)
    if len(t["rows"]):
        r = ref.head(f, t["rows"], t["cols"], K)
        l1 = lambda a, b, dims: (a - b).abs().sum(dims).sum() / nv  # noqa: E731
        terms["offset"] = l1(r["offset"], t["offset"], -1)
        terms["rotmat"] = l1(r["rotmat"], t["rotmat"], (-1, -2, -3))
        terms["shape"] = l1(r["shape"], t["shape"], -1)
        terms["dist"] = (r["dist_postprocessed"][:, 0] - t["dist"]).abs().sum() / nv
        terms["transl"] = l1(r["transl"], t["transl"], -1)
        for k in ("j3d", "v3d"):
            err = ((t[k] - t["pelvis"]) - (r[k] - r["transl_pelvis"])).abs().sum(-1).mean(-1)
            terms[k] = err.sum() / nv
    return sum(WEIGHTS[k] * v for k, v in terms.items()), terms


def steps(ref: Reference, batches: list, lr: float, n: int = 3,
          betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """``n`` steps of forward, backward and Adam from the reference's
    weights. Returns each step's loss and its terms, every leaf's gradient norm at the
    first step, every element's change after the last step (``delta``) and
    the elements whose first gradient is nought to rounding (``still``:
    under a thousandth of the median leaf's root mean square), which move
    under Adam by round-off alone, as a key's bias does under softmax."""
    w = ref.w
    for v in w.values():
        v.requires_grad_(True)
    w0 = {k: v.detach().clone() for k, v in w.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, step_terms, grad1, still = [], [], {}, {}
    for step in range(1, n + 1):
        batch = {k: torch.as_tensor(a, dtype=torch.float32, device=ref.device)
                 for k, a in batches[step - 1].items()}
        ts = targets(ref, batch)
        counts = {"pos": float(sum(t["heat"].sum() for t in ts)),
                  "valid": float(sum(len(t["rows"]) for t in ts))}
        for v in w.values():
            v.grad = None
        total, parts = 0.0, dict.fromkeys(WEIGHTS, 0.0)
        for b, t in enumerate(ts):
            loss, terms = image_loss(ref, batch["image"][b], batch["K"][b], t, counts)
            loss.backward()
            total += float(loss.detach())
            for k, v in terms.items():
                parts[k] += float(v.detach())
        losses.append(total)
        step_terms.append(parts)
        with torch.no_grad():
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in w.items()}
            if step == 1:
                grad1 = {k: float(g.norm()) for k, g in grads.items()}
                rms = sorted(float(g.norm()) / g.numel() ** 0.5 for g in grads.values())
                floor = 1e-3 * rms[len(rms) // 2]
                still = {k: g.abs() < floor for k, g in grads.items()}
            for k, p in w.items():
                gr = grads[k]
                m[k].mul_(betas[0]).add_(gr, alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(gr, gr, value=1 - betas[1])
                c1, c2 = 1 - betas[0] ** step, 1 - betas[1] ** step
                p.sub_(lr / c1 * m[k] / (v2[k].sqrt() / math.sqrt(c2) + eps))
    delta = {k: (w[k].detach() - w0[k]) for k in w}
    return {"losses": losses, "terms": step_terms, "grad1": grad1, "delta": delta,
            "still": still}
