"""Evaluation metrics: detection PRF1, greedy 2D matching, PVE family, and
the training meter (``multihmr_tpu/train/metrics.py``).

A copy of the JAX package's numpy module, held equal to it by
``tests/test_torch_data.py``. Host-side numpy equivalents of reference
utils/training.py:9-225 and the metric math inside ``Trainer.evaluate``
(reference train.py:336-482). The matcher follows the ROMP-style greedy
protocol the reference uses: repeatedly take the globally closest
(pred, gt) pair by L2 distance over valid keypoints; accept it if both are
unassigned and the keypoint bounding boxes overlap with IoU >= 0.05, count a
false positive when the closest pair for a prediction fails the IoU gate.
The per-mesh errors run once per matched person on the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def compute_prf1(count: int, miss: int, fp: int) -> Tuple[float, float, float]:
    """Precision/recall/F1 in percent, rounded like the reference
    (utils/training.py:9-23)."""
    if count == 0:
        return 0, 0, 0
    tp = count - miss
    fn = miss
    if tp == 0:
        return 0.0, 0.0, 0.0
    f1 = round(tp / (tp + 0.5 * (fp + fn)), 2)
    recall = round(tp / (tp + fn), 2)
    precision = round(tp / (tp + fp), 2)
    return 100.0 * precision, 100.0 * recall, 100.0 * f1


def _bbox_iou_plus1(p1: np.ndarray, p2: np.ndarray) -> float:
    """IoU of keypoint-set bounding boxes with the reference's +1 pixel
    inclusive-area convention (utils/training.py:149-194)."""
    a_min, a_max = p1.min(0), p1.max(0)
    b_min, b_max = p2.min(0), p2.max(0)
    x_left = max(a_min[0], b_min[0])
    y_top = max(a_min[1], b_min[1])
    x_right = min(a_max[0], b_max[0])
    y_bottom = min(a_max[1], b_max[1])
    inter = max(0.0, x_right - x_left + 1) * max(0.0, y_bottom - y_top + 1)
    area_a = (a_max[0] - a_min[0] + 1) * (a_max[1] - a_min[1] + 1)
    area_b = (b_max[0] - b_min[0] + 1) * (b_max[1] - b_min[1] + 1)
    return inter / float(area_a + area_b - inter)


def match_2d_greedy(
    pred_kps: Sequence[np.ndarray],
    gt_kps: Sequence[np.ndarray],
    valid_mask: Sequence[np.ndarray],
    iou_thresh: float = 0.05,
) -> Tuple[np.ndarray, List[int], List[int]]:
    """Greedy bipartite matching of predicted to GT people in 2D.

    Returns (bestMatch [(pred_idx, gt_idx)...], falsePositives, misses) with
    the reference's protocol (utils/training.py:25-147).
    """
    n_pred, n_gt = len(pred_kps), len(gt_kps)
    if n_pred == 0:
        return np.zeros((0, 2), int), [], list(range(n_gt))
    if n_gt == 0:
        return np.zeros((0, 2), int), list(range(n_pred)), []

    pairs = [(i, j) for i in range(n_pred) for j in range(n_gt)]
    errors = np.array(
        [
            np.linalg.norm(pred_kps[i][valid_mask[j], :2] - gt_kps[j][valid_mask[j], :2])
            for i, j in pairs
        ]
    )
    pred_assigned = np.zeros(n_pred, bool)
    gt_assigned = np.zeros(n_gt, bool)
    best_match = []
    fp_counter = 0
    while gt_assigned.sum() < n_gt and pred_assigned.sum() + fp_counter < n_pred:
        # walk pairs by increasing error until one is actionable
        action = None  # "match" | "fp" | None (exhausted)
        while not np.isinf(errors).all():
            m = int(np.argmin(errors))
            i, j = pairs[m]
            iou = _bbox_iou_plus1(pred_kps[i], gt_kps[j])
            errors[m] = np.inf
            if not pred_assigned[i] and not gt_assigned[j] and iou >= iou_thresh:
                action = "match"
                break
            if iou < iou_thresh:
                action = "fp"
                break
        if action is None:
            break
        if action == "match":
            best_match.append((i, j))
            pred_assigned[i] = True
            gt_assigned[j] = True
        else:
            fp_counter += 1

    matched_preds = {i for i, _ in best_match}
    matched_gts = {j for _, j in best_match}
    false_positives = [i for i in range(n_pred) if i not in matched_preds]
    misses = [j for j in range(n_gt) if j not in matched_gts]
    return np.asarray(best_match, int).reshape(-1, 2), false_positives, misses


def pve(pred_verts, gt_verts, pred_pelvis, gt_pelvis) -> np.ndarray:
    """Pelvis-centered per-vertex error in mm (reference train.py:373-388).
    Inputs ``[..., V, 3]`` meters; pelvis ``[..., 1, 3]``."""
    err = np.linalg.norm(
        (np.asarray(pred_verts) - np.asarray(pred_pelvis))
        - (np.asarray(gt_verts) - np.asarray(gt_pelvis)),
        axis=-1,
    )
    return 1000.0 * err.mean(-1)


def pa_pve(pred_verts, gt_verts) -> np.ndarray:
    """Procrustes-aligned per-vertex error in mm (reference train.py:391-394).

    Host-side Kabsch/Umeyama, numerically mirroring the JAX package's
    ``ops/rotations.py::rigid_points_registration``: it runs once per
    matched person inside the eval loop, on 3x3 SVDs numpy does in
    microseconds.
    """
    pred = np.asarray(pred_verts, np.float64)
    gt = np.asarray(gt_verts, np.float64)
    mu_x = pred.mean(-2, keepdims=True)
    mu_y = gt.mean(-2, keepdims=True)
    xc, yc = pred - mu_x, gt - mu_y
    cov = np.einsum("...ni,...nj->...ij", yc, xc)  # (..., 3, 3)
    U, S, Vt = np.linalg.svd(cov)
    det = np.linalg.det(U @ Vt)
    d = np.where(det < 0, -1.0, 1.0)  # det >= 0 → +1 (degenerate-safe)
    D = np.broadcast_to(np.eye(3), cov.shape).copy()
    D[..., 2, 2] = d
    R = U @ D @ Vt
    var_x = np.sum(xc * xc, axis=(-1, -2))
    s = np.sum(S * np.stack([np.ones_like(d), np.ones_like(d), d], -1), -1) / np.maximum(var_x, 1e-24)
    t = mu_y[..., 0, :] - s[..., None] * np.einsum("...ij,...j->...i", R, mu_x[..., 0, :])
    aligned = s[..., None, None] * np.einsum("...ij,...nj->...ni", R, pred) + t[..., None, :]
    err = np.linalg.norm(aligned - gt, axis=-1).mean(-1)
    return 1000.0 * err


class AverageMeter:
    """Running average (reference utils/training.py:197-225)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        return f"{self.name} {self.val:{self.fmt[1:]}} ({self.avg:{self.fmt[1:]}})"
