"""Evaluation harness (``multihmr_tpu/train/evaluate.py``), the analogue of
reference train.py:336-482.

Per image: forward the model, greedily match predicted people to GT in 2D,
accumulate PVE and PA-PVE (and MPJPE / PA-MPJPE through the H36M regressor
for 3DPW), plus precision/recall/F1 from the matching. The metric math is
the JAX package's numpy, copied into ``train/metrics.py``.

Two differences from the JAX package, both chosen: a ``J_regressor_h36m``
that cannot take the predictions' vertex count (SMPL-X predictions without
``smplx2smpl``) raises a ``ValueError`` before the first image, where the
JAX package fails inside an einsum at the first match; and the matcher sees
the predictions' joints truncated to the GT's joint count, as in the JAX
package and the reference, so on 3DPW SMPL-X joints 22-23 (jaw, left eye)
stand against SMPL's hands. ``visu_to_save`` saves [input | prediction |
GT] triptychs of the first images, rendered on the host
(``render/render.py::render_meshes``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from multihmr_tpu_torch.bodymodel.constants import H36M_TO_J14
from multihmr_tpu_torch.bodymodel.core import BodyModel, lbs_forward
from multihmr_tpu_torch.ops.camera import perspective_projection
from multihmr_tpu_torch.ops.rotations import rotvec_to_rotmat
from multihmr_tpu_torch.train.metrics import (
    AverageMeter,
    compute_prf1,
    match_2d_greedy,
    pa_pve,
    pve as pve_fn,
)


@torch.no_grad()
def _posed(bm: BodyModel, pose, shape, transl, K):
    """Numpy (v3d, j3d, j2d) of persons' axis-angle ``pose [P, J, 3]``,
    ``shape`` and ``transl`` through ``lbs_forward`` on the body model's
    device, projected by ``K [3, 3]``."""
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(bm.v_template.device)  # noqa: E731
    out = lbs_forward(bm, rotvec_to_rotmat(as_t(pose)), as_t(shape))
    v3d = out["vertices"] + as_t(transl)[:, None]
    j3d = out["joints"] + as_t(transl)[:, None]
    j2d = perspective_projection(j3d, as_t(K)[None])
    return v3d.cpu().numpy(), j3d.cpu().numpy(), j2d.cpu().numpy()


def make_smplx_gt_forward(body_model: BodyModel, num_betas: int = 11):
    """GT forward for datasets that store SMPL-X parameters (BEDLAM):
    ``annot['humans']`` entries with ``smplx_*`` keys → numpy
    ``{v3d [P, V, 3], j3d [P, J, 3], j2d [P, J, 2]}``, through the same
    ``lbs_forward`` as training, on the body model's device. Eager torch
    needs none of the JAX version's fixed-capacity padding."""

    def gt_forward(annot):
        humans = annot["humans"]
        pose = np.stack([
            np.concatenate([h["smplx_root_pose"], h["smplx_body_pose"], h["smplx_jaw_pose"],
                            h["smplx_leye_pose"], h["smplx_reye_pose"],
                            h["smplx_left_hand_pose"], h["smplx_right_hand_pose"]], 0)
            for h in humans])
        shape = np.stack([h["smplx_shape"][:num_betas] for h in humans])
        transl = np.stack([h["smplx_transl"] for h in humans])
        v3d, j3d, j2d = _posed(body_model, pose, shape, transl, annot["K"])
        return {"v3d": v3d, "j3d": j3d, "j2d": j2d}

    return gt_forward


def make_smpl_gt_forward(body_models: Dict[str, BodyModel], capacity: int = 16):
    """GT forward for datasets that store gendered SMPL parameters (3DPW):
    ``annot['humans']`` entries with ``smpl_*`` keys and ``smpl_gender`` →
    numpy ``{v3d [P, 6890, 3], j3d [P, J, 3], j2d [P, J, 2]}``. Persons are
    grouped by gender, run through that gender's body model in chunks of at
    most ``capacity``, and scattered back to their order (reference
    train.py:58-96, 351-357).

    The GT vertices are SMPL topology: comparing them with SMPL-X
    predictions needs the ``smplx2smpl`` regressor (reference
    train.py:383-384)."""

    def gt_forward(annot):
        humans = annot["humans"]
        outs = [None] * len(humans)
        for g, bm in body_models.items():
            idxs = [i for i, h in enumerate(humans) if h["smpl_gender"] == g]
            if not idxs:
                continue
            pose = np.stack([np.concatenate([humans[i]["smpl_root_pose"],
                                             humans[i]["smpl_body_pose"]], 0) for i in idxs])
            shape = np.stack([humans[i]["smpl_shape"] for i in idxs])
            transl = np.stack([humans[i]["smpl_transl"] for i in idxs])
            for s in range(0, len(idxs), capacity):
                chunk = slice(s, s + capacity)
                v3d, j3d, j2d = _posed(bm, pose[chunk], shape[chunk], transl[chunk], annot["K"])
                for k, i in enumerate(idxs[chunk]):
                    outs[i] = (v3d[k], j3d[k], j2d[k])
        v3d, j3d, j2d = (np.stack(parts) for parts in zip(*outs))
        return {"v3d": v3d, "j3d": j3d, "j2d": j2d}

    return gt_forward


def _project_np(j3d: np.ndarray, K: np.ndarray) -> np.ndarray:
    """``perspective_projection`` in host numpy (K·(x/z), utils/camera.py:14-27)."""
    y = j3d / j3d[..., -1:]
    return np.einsum("ij,...kj->...ki", np.asarray(K, np.float64), y)[..., :2]


def _save_eval_visu(visu_dir, idx, x, annot, persons, gt, faces):
    """Save an [input | prediction | GT] triptych for eval debugging."""
    import os

    from multihmr_tpu_torch.ops.image import IMG_NORM_MEAN, IMG_NORM_STD
    from multihmr_tpu_torch.render import render_meshes

    os.makedirs(visu_dir, exist_ok=True)
    img = np.clip((np.asarray(x) * IMG_NORM_STD + IMG_NORM_MEAN) * 255, 0, 255).astype(
        np.uint8
    )
    K = np.asarray(annot["K"])
    pred_arr = render_meshes(
        img, [np.asarray(p["v3d"]) for p in persons], [faces] * len(persons), K
    )
    gt_arr = render_meshes(img, list(gt["v3d"]), [faces] * len(gt["v3d"]), K)
    strip = np.concatenate([img, pred_arr, gt_arr], axis=1)
    try:
        from PIL import Image

        Image.fromarray(strip).save(os.path.join(visu_dir, f"eval_{idx:04d}.png"))
    except ImportError:  # pragma: no cover
        np.save(os.path.join(visu_dir, f"eval_{idx:04d}.npy"), strip)


def evaluate_dataset(
    model,
    dataset,
    det_thresh: float = 0.3,
    nms_kernel_size: int = 3,
    smplx2smpl: Optional[np.ndarray] = None,  # [6890, 10475] for 3DPW
    J_regressor_h36m: Optional[np.ndarray] = None,  # [17, 6890]
    gt_forward: Optional[Callable] = None,
    max_images: Optional[int] = None,
    log_every: int = 50,
    log_fn=print,
    visu_to_save: int = 0,
    visu_dir: str = "eval_visu",
    faces: Optional[np.ndarray] = None,
    pipeline: Optional[bool] = None,
) -> Dict[str, float]:
    """Run eval over a dataset yielding (image NHWC, annot dict) with the
    model's own weights (a :class:`~multihmr_tpu_torch.models.multihmr.MultiHMR`
    on its device).

    ``gt_forward(annot) -> dict(v3d [P,V,3], j3d [P,J,3], j2d [P,J,2])``
    supplies GT meshes for datasets that store parameters rather than
    vertices; EHF-style datasets with ``smplx_vertices`` are handled
    natively (GT joints regressed with the model's J_regressor, reference
    train.py:72-74). ``smplx2smpl`` maps the predicted vertices to the GT's
    SMPL topology (3DPW); ``J_regressor_h36m`` adds ``mpjpe`` and
    ``pa_mpjpe`` over the 14 H36M joints. ``visu_to_save`` > 0 with the
    body model's ``faces`` writes ``visu_dir/eval_<i>.png`` for the first
    images: [input | prediction | GT] (reference train.py:441-469).

    With ``pipeline=True`` the loop enqueues image *i+1*'s forward on the
    card before image *i*'s result is read back, so the card computes while
    the host matches and scores; with ``False`` it is the reference's serial
    loop. ``None`` (the default) pipelines only where there is per-image
    host work to hide (a ``gt_forward`` or eval visualization), as the JAX
    package does. Images of dtype ``uint8`` are uploaded as they are and
    normalized on the device (``/255``, then ``IMG_NORM_MEAN`` and
    ``IMG_NORM_STD`` in fp32), a quarter of the upload bytes.
    ``results['timings']`` attributes the wall clock: load / dispatch / wait
    / readback / gt / match_metrics / visu sum to about the wall."""
    from multihmr_tpu_torch.ops.image import IMG_NORM_MEAN, IMG_NORM_STD

    if pipeline is None:  # auto: overlap only where there is host work to hide
        pipeline = gt_forward is not None or visu_to_save > 0
    device = next(model.net.parameters()).device
    norm_mean = torch.from_numpy(IMG_NORM_MEAN).to(device)
    norm_std = torch.from_numpy(IMG_NORM_STD).to(device)
    n_pred_verts = model.body_model.num_vertices if smplx2smpl is None else smplx2smpl.shape[0]
    if J_regressor_h36m is not None and J_regressor_h36m.shape[1] != n_pred_verts:
        raise ValueError(
            f"J_regressor_h36m {tuple(J_regressor_h36m.shape)} needs predictions on its "
            f"{J_regressor_h36m.shape[1]}-vertex topology; they have {n_pred_verts} vertices "
            "(pass smplx2smpl to map SMPL-X predictions to SMPL)")
    meters = {k: AverageMeter(k) for k in ["pve", "pa_pve", "mpjpe", "pa_mpjpe"]}
    count = miss = fp = 0
    timings = {k: 0.0 for k in (
        "load", "dispatch", "wait", "readback", "gt", "match_metrics", "visu")}
    n = len(dataset) if max_images is None else min(len(dataset), max_images)

    def dispatch(i):
        t0 = time.perf_counter()
        x, annot = dataset[i]
        t1 = time.perf_counter()
        with torch.inference_mode():
            xs = np.asarray(x[None])
            if xs.dtype == np.uint8:  # u8 wire: normalize on the device
                xs = torch.from_numpy(xs).to(device).float() / 255.0
                xs = (xs - norm_mean) / norm_std
            else:
                xs = torch.from_numpy(xs.astype(np.float32, copy=False)).to(device)
            out = model.forward(
                xs, torch.from_numpy(np.asarray(annot["K"][None], np.float32)).to(device),
                det_thresh=det_thresh, nms_kernel_size=nms_kernel_size)
        timings["load"] += t1 - t0
        timings["dispatch"] += time.perf_counter() - t1
        return i, x, annot, out

    def process(item):
        nonlocal count, miss, fp
        i, x, annot, out = item
        t0 = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        persons = model.extract_persons(out, fields=["v3d", "j2d", "transl_pelvis"])[0]
        t2 = time.perf_counter()
        timings["wait"] += t1 - t0
        timings["readback"] += t2 - t1

        # ---- GT meshes (host-only for vertex GT) ----
        if gt_forward is not None:
            gt = gt_forward(annot)
        elif "smplx_vertices" in annot["humans"][0]:
            verts = np.stack([h["smplx_vertices"] for h in annot["humans"]])
            Jreg = model.body_model.J_regressor.cpu().numpy()
            j3d = np.einsum("jv,pvc->pjc", Jreg, verts)
            j2d = _project_np(j3d, annot["K"]).astype(np.float32)
            gt = {"v3d": verts, "j3d": j3d, "j2d": j2d}
        else:
            raise ValueError("dataset provides no GT meshes and no gt_forward")
        t3 = time.perf_counter()
        timings["gt"] += t3 - t2

        # eval-time visualization (reference train.py:441-469: saves
        # image/pred/GT triptychs for the first --visu_to_save images)
        if i < visu_to_save and faces is not None:
            _save_eval_visu(visu_dir, i, x, annot, persons, gt, faces)
            timings["visu"] += time.perf_counter() - t3
            t3 = time.perf_counter()

        n_gt = gt["v3d"].shape[0]
        count += n_gt
        if not persons:
            miss += n_gt
            timings["match_metrics"] += time.perf_counter() - t3
            return

        # predictions truncated to the GT joint count (reference train.py:361)
        n_j = gt["j2d"].shape[1]
        pred_j2d = [np.asarray(p["j2d"])[:n_j] for p in persons]
        valid_mask = [np.ones(n_j, bool)] * n_gt
        best, fps, misses = match_2d_greedy(pred_j2d, list(gt["j2d"]), valid_mask)
        fp += len(fps)
        miss += len(misses)

        for pi, gi in best:
            p_pel = np.asarray(persons[pi]["transl_pelvis"]).reshape(1, 1, 3)
            g_pel = gt["j3d"][gi][:1][None]
            # center at the pelvis before the regressors (reference
            # train.py:373-385): regressing the O(0.3 m) centred mesh keeps
            # the fp32 digits that O(camera-distance) coordinates would lose
            pv = np.asarray(persons[pi]["v3d"])[None] - p_pel
            gv = gt["v3d"][gi][None] - g_pel
            if smplx2smpl is not None:  # 3DPW: SMPL-X vertices → SMPL topology
                pv = np.einsum("sv,bvc->bsc", smplx2smpl, pv)
            meters["pve"].update(float(pve_fn(pv, gv, 0.0, 0.0)[0]))
            meters["pa_pve"].update(float(pa_pve(pv, gv)[0]))
            if J_regressor_h36m is not None:
                # centre at H36M joint 0 (the pelvis) before the J14 subset,
                # whose first entry is not the pelvis (reference
                # train.py:406-415)
                pj = np.einsum("js,bsc->bjc", J_regressor_h36m, pv)
                gj = np.einsum("js,bsc->bjc", J_regressor_h36m, gv)
                pj = (pj - pj[:, :1])[:, H36M_TO_J14]
                gj = (gj - gj[:, :1])[:, H36M_TO_J14]
                meters["mpjpe"].update(float(1000 * np.linalg.norm(pj - gj, axis=-1).mean()))
                meters["pa_mpjpe"].update(float(pa_pve(pj, gj)[0]))
        timings["match_metrics"] += time.perf_counter() - t3
        if log_every and (i + 1) % log_every == 0:
            log_fn(f"[{i+1}/{n}] pve={meters['pve'].avg:.1f} "
                   f"pa_pve={meters['pa_pve'].avg:.1f}")

    t_start = time.perf_counter()
    if pipeline:
        in_flight = None
        for i in range(n):
            nxt = dispatch(i)  # the card starts image i ...
            if in_flight is not None:
                process(in_flight)  # ... while the host scores image i-1
            in_flight = nxt
        if in_flight is not None:
            process(in_flight)
    else:  # reference-shaped serial loop (train.py:351-357)
        for i in range(n):
            process(dispatch(i))
    wall = time.perf_counter() - t_start

    precision, recall, f1 = compute_prf1(count, miss, fp)
    results = {
        "pve": meters["pve"].avg,
        "pa_pve": meters["pa_pve"].avg,
        "precision": precision,
        "recall": recall,
        "f1_score": f1,
        "n_images": n,
        "timings": {**{k: round(v, 4) for k, v in timings.items()},
                    "wall": round(wall, 4)},
    }
    if J_regressor_h36m is not None:
        results["mpjpe"] = meters["mpjpe"].avg
        results["pa_mpjpe"] = meters["pa_mpjpe"].avg
    return results
