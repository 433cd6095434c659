"""Training losses (``multihmr_tpu/train/loss.py``).

The CenterNet penalty-reduced focal loss on the detection heatmap plus L1
regression terms over the padded ``[B, K]`` person slots, each a masked mean
over the valid slots. Every term goes through ``nan_to_num`` as in the JAX
package, and the ``finite`` flag records whether the raw terms were finite,
so that a trainer can see a model whose loss ``nan_to_num`` turned into 0.

Data parallelism (``group=``, the mesh's ``data`` axis): each rank holds a
slice of the batch, and the JAX loss divides its masked sums by the counts
of the *whole* batch (``loss.py:51-55, 59-62, 117-119``). So the counts
(the focal loss's positives, the valid slots, the in-frame 2D weights) are
summed over the group, and each rank's terms are its own sums over those
global counts: the terms add up over the ranks to the whole batch's, and so
do the gradients, which the trainer sums (not averages) over ``data``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LossWeights:
    alpha_bce: float = 10.0
    alpha_offset: float = 1.0
    alpha_rotmat: float = 0.1
    alpha_shape: float = 1.0
    alpha_dist: float = 1.0
    alpha_transl: float = 1.0
    alpha_j3d: float = 100.0
    alpha_v3d: float = 100.0
    alpha_j2d: float = 1.0
    alpha_v2d: float = 1.0
    start_2d_epoch: int = 10


def centernet_focal_loss(pred, gt, num_pos=None):
    """Penalty-reduced pixelwise focal loss: ``pred`` clamped-sigmoid scores,
    ``gt`` the target heatmap in [0, 1] with exact 1.0 at person centres.
    ``num_pos``: the count of positives to divide by (default this ``gt``'s)."""
    eps = 1e-7
    pos = (gt == 1.0).to(pred.dtype)
    neg = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - gt, 4)
    pos_loss = torch.log(pred + eps) * torch.square(1.0 - pred) * pos
    neg_loss = torch.log(1.0 - pred + eps) * torch.square(pred) * neg_weights * neg
    if num_pos is None:
        num_pos = pos.sum()
    pos_sum, neg_sum = pos_loss.sum(), neg_loss.sum()
    return torch.where(num_pos == 0, -neg_sum, -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0))


def _masked_mean(per_person, valid, count):
    """Sum over the valid person slots of ``per_person [B, K]`` over ``count``."""
    return (per_person * valid).sum() / torch.clamp(count, min=1.0)


def _nan0(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _in_frame_weights(gt_pts, valid, img_size):
    """``[B, K, P]`` weights of the GT points inside the frame."""
    return ((gt_pts > 0) & (gt_pts < img_size)).all(-1).float() * valid[..., None]


def multihmr_loss(pred: dict, gt: dict, weights: LossWeights, epoch: int = 0,
                  img_size: int = 896, group=None):
    """(total, per-term dict). ``pred`` is a model forward output (padded
    ``[B, K, ...]``); ``gt`` holds the same keys plus ``scores`` (target
    heatmap) and ``valid`` (``[B, K]`` person mask). The 2D terms join the
    total from ``weights.start_2d_epoch`` on. ``group``: the data-parallel
    ranks whose batch slices make the batch (see the module docstring)."""
    valid = gt["valid"]
    heat = (gt["scores"] >= 1.0).float()
    w_v2d = _in_frame_weights(gt["v2d"], valid, img_size)
    w_j2d = _in_frame_weights(gt["j2d"], valid, img_size)
    counts = torch.stack([(heat == 1.0).to(pred["scores"].dtype).sum(), valid.sum(),
                          w_v2d.sum(), w_j2d.sum()])
    if group is not None:  # the whole batch's counts
        from multihmr_tpu_torch.parallel.comm import all_reduce

        counts = all_reduce(counts.detach(), group)
    num_pos, n_valid, n_v2d, n_j2d = counts.unbind()
    bce = centernet_focal_loss(pred["scores"], heat, num_pos)
    reg_offset = _masked_mean((pred["offset"] - gt["offset"]).abs().sum(-1), valid, n_valid)
    reg_rotmat = _masked_mean((pred["rotmat"] - gt["rotmat"]).abs().sum((-1, -2, -3)), valid,
                              n_valid)
    sdim = min(pred["shape"].shape[-1], gt["shape"].shape[-1])
    reg_shape = _masked_mean(
        (pred["shape"][..., :sdim] - gt["shape"][..., :sdim]).abs().sum(-1), valid, n_valid)
    reg_dist = _masked_mean(
        (pred["dist_postprocessed"][..., 0] - gt["dist_postprocessed"]).abs(), valid, n_valid)
    reg_transl = _masked_mean((pred["transl"] - gt["transl"]).abs().sum(-1), valid, n_valid)

    # pelvis-centred 3D
    pel_p = pred["transl_pelvis"].reshape(pred["transl_pelvis"].shape[:2] + (1, 3))
    pel_g = gt["transl_pelvis"].reshape(gt["transl_pelvis"].shape[:2] + (1, 3))
    j3d_err = ((gt["j3d"] - pel_g) - (pred["j3d"] - pel_p)).abs().sum(-1).mean(-1)
    v3d_err = ((gt["v3d"] - pel_g) - (pred["v3d"] - pel_p)).abs().sum(-1).mean(-1)
    reg_j3d = _masked_mean(j3d_err, valid, n_valid)
    reg_v3d = _masked_mean(v3d_err, valid, n_valid)

    # 2D reprojection over the GT points inside the frame
    def masked_2d(pred_pts, gt_pts, w, count):
        err = (pred_pts - gt_pts).abs().sum(-1)
        return (err * w).sum() / torch.clamp(count, min=1.0)

    reg_v2d = masked_2d(pred["v2d"], gt["v2d"], w_v2d, n_v2d)
    reg_j2d = masked_2d(pred["j2d"], gt["j2d"], w_j2d, n_j2d)

    raw = {"bce": bce, "offset": reg_offset, "rotmat": reg_rotmat, "shape": reg_shape,
           "dist": reg_dist, "transl": reg_transl, "j3d": reg_j3d, "v3d": reg_v3d,
           "j2d": reg_j2d, "v2d": reg_v2d}
    terms = {"finite": torch.isfinite(torch.stack(list(raw.values()))).all().float()}
    terms.update({k: _nan0(v) for k, v in raw.items()})
    total = (weights.alpha_bce * terms["bce"]
             + weights.alpha_offset * terms["offset"]
             + weights.alpha_rotmat * terms["rotmat"]
             + weights.alpha_shape * terms["shape"]
             + weights.alpha_dist * terms["dist"]
             + weights.alpha_transl * terms["transl"]
             + weights.alpha_j3d * terms["j3d"]
             + weights.alpha_v3d * terms["v3d"])
    if epoch >= weights.start_2d_epoch:
        total = total + weights.alpha_j2d * terms["j2d"] + weights.alpha_v2d * terms["v2d"]
    terms["total"] = total
    return total, terms
