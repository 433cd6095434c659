"""Training: GT preparation, train step, fit loop (``multihmr_tpu/train/trainer.py``).

  * :func:`prepare_gt` builds the targets from raw SMPL-X parameters: the
    batched GT body-model forward (the same ``lbs_forward`` as the model)
    and the same-patch collision drop as an O(K^2) masked comparison;
  * :func:`make_train_step` gives one step = forward + loss + backward +
    Adam update, in place on the model and the optimizer;
  * :class:`Trainer` runs epochs with a windowed loss fetch, a NaN-streak
    abort, data/batch meters, per-epoch checkpoints and a bitwise resume.

The JAX package's mesh/FSDP arguments (multi-device training) are not here:
one device only, until the multi-device slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from multihmr_tpu_torch.bodymodel.constants import get_smplx_joint_names
from multihmr_tpu_torch.bodymodel.core import BodyModel, lbs_forward
from multihmr_tpu_torch.io import checkpoint as ckpt
from multihmr_tpu_torch.ops.camera import (
    focal_length_normalization,
    log_depth,
    perspective_projection,
)
from multihmr_tpu_torch.ops.detection import Detections
from multihmr_tpu_torch.ops.rotations import rotvec_to_rotmat
from multihmr_tpu_torch.train.loss import LossWeights, multihmr_loss
from multihmr_tpu_torch.train.metrics import AverageMeter

BATCH_KEYS = ("image", "K", "gt_pose", "gt_shape", "gt_transl", "gt_valid")


@torch.no_grad()
def prepare_gt(body_model: BodyModel, gt_pose, gt_shape, gt_transl, valid, K,
               img_size: int, patch_size: int = 14, person_center: str = "head",
               nearness: bool = True, fovn: int = 60) -> dict:
    """Training targets from ``gt_pose [B, Kh, 53, 3]`` axis-angle (root,
    body, left hand, right hand, jaw), ``gt_shape [B, Kh, nb]``,
    ``gt_transl [B, Kh, 3]``, ``valid [B, Kh]`` and ``K [B, 3, 3]``.

    Returns a dict keyed like the model output plus ``scores`` (binary
    heatmap), ``valid`` (after the collision drop) and ``det``."""
    B, Kh = valid.shape
    g = img_size // patch_size
    center_idx = get_smplx_joint_names().index(person_center)

    # GT body-model forward (SMPL-X joint order) over the flattened persons
    flat = lambda t: t.reshape((B * Kh,) + t.shape[2:])  # noqa: E731
    rotmats = rotvec_to_rotmat(flat(gt_pose))  # [BK, 53, 3, 3]
    root, body = rotmats[:, 0:1], rotmats[:, 1:22]
    lhand, rhand, jaw = rotmats[:, 22:37], rotmats[:, 37:52], rotmats[:, 52:53]
    eyes = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device).expand(B * Kh, 2, 3, 3)
    model_rots = torch.cat([root, body, jaw, eyes, lhand, rhand], dim=1)
    out = lbs_forward(body_model, model_rots, flat(gt_shape))
    verts = out["vertices"] + flat(gt_transl)[:, None]
    jts = out["joints"] + flat(gt_transl)[:, None]
    unflat = lambda t: t.reshape((B, Kh) + t.shape[1:])  # noqa: E731
    verts, jts = unflat(verts), unflat(jts)

    j2d = perspective_projection(jts, K[:, None])
    v2d = perspective_projection(verts, K[:, None])

    transl = jts[:, :, center_idx]  # [B, Kh, 3] primary keypoint
    transl_pelvis = jts[:, :, 0]
    dist = jts[:, :, 0, -1]  # pelvis z
    nd = log_depth(dist) if nearness else dist
    dist_post = focal_length_normalization(nd, K[:, 0, 0][:, None], fovn=fovn,
                                           img_size=img_size)

    # heatmap cell and offset of the primary keypoint
    pk_loc = perspective_projection(transl[:, :, None], K[:, None])[:, :, 0]  # (x, y)
    pk_idx = torch.clamp(torch.floor(pk_loc / patch_size).long(), 0, g - 1)
    offset = (pk_loc - (pk_idx + 0.5) * patch_size) / patch_size

    rows, cols = pk_idx[..., 1], pk_idx[..., 0]
    flat_cell = rows * g + cols
    # collision drop: slot k is invalid if an earlier valid slot hits its cell
    same = (flat_cell[:, :, None] == flat_cell[:, None, :]).float()
    earlier = torch.tril(torch.ones((Kh, Kh), device=valid.device), diagonal=-1)[None]
    collided = (same * earlier * valid[:, None, :]).sum(-1) > 0
    vis = valid * (1.0 - collided.float())

    scores = torch.zeros((B, g * g), device=valid.device).scatter_reduce(
        1, flat_cell, vis, reduce="amax")  # scores.at[b, cell].max(vis)
    ivis = vis.long()
    det = Detections(rows=rows * ivis, cols=cols * ivis, scores=vis, valid=vis)
    return {
        "det": det,
        "valid": vis,
        "scores": scores.reshape(B, g, g),
        "loc": pk_loc,
        "offset": offset,
        "transl": transl,
        "transl_pelvis": transl_pelvis,
        "dist": dist[..., None],
        "dist_postprocessed": dist_post,
        "rotvec": gt_pose,
        "rotmat": unflat(rotmats),
        "shape": gt_shape,
        "v3d": verts,
        "j3d": jts,
        "j2d": j2d,
        "v2d": v2d,
    }


def to_device(batch: dict, device) -> dict:
    """A collated numpy (or torch) batch as fp32 tensors on ``device``."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=device, dtype=torch.float32)
    return {k: one(batch[k]) for k in BATCH_KEYS}


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    weights: LossWeights = LossWeights(),
                    gt_body_model: Optional[BodyModel] = None,
                    person_center: str = "head", clip_grad: float = 0.0):
    """``train_step(batch, epoch) -> terms``: forward, loss, backward and one
    optimizer step, updating ``model.net`` and ``optimizer`` in place.
    ``batch`` holds :data:`BATCH_KEYS` as tensors on the model's device;
    ``terms`` are the loss terms as detached device scalars.

    ``clip_grad > 0`` clips the global gradient norm with
    ``torch.nn.utils.clip_grad_norm_`` where the JAX CLI chains
    ``optax.clip_by_global_norm``. They differ by a hair: torch scales by
    ``clip / (norm + 1e-6)`` whenever that is below 1, optax by
    ``clip / norm`` when ``norm > clip``.

    ``optimizer`` should be ``torch.optim.Adam(params, lr, eps=1e-8)`` for
    the JAX package's ``optax.adam(lr)``: the same update,
    m_hat / (sqrt(v_hat) + eps)."""
    gt_bm = gt_body_model if gt_body_model is not None else model.body_model
    cfg = model.cfg
    params = [p for p in model.net.parameters() if p.requires_grad]

    def train_step(batch: dict, epoch: int) -> dict:
        model.net.train()
        gt = prepare_gt(gt_bm, batch["gt_pose"], batch["gt_shape"], batch["gt_transl"],
                        batch["gt_valid"], batch["K"], img_size=cfg.img_size,
                        patch_size=cfg.patch_size, person_center=person_center,
                        nearness=cfg.nearness, fovn=cfg.fovn)
        pred = dict(model.forward(batch["image"], batch["K"], is_training=True,
                                  gt_det=gt["det"]))
        pred["scores"] = pred["scores"][..., None]  # heatmap rank of the loss
        gt = dict(gt, scores=gt["scores"][..., None])
        total, terms = multihmr_loss(pred, gt, weights, epoch=epoch, img_size=cfg.img_size)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if clip_grad > 0:
            torch.nn.utils.clip_grad_norm_(params, clip_grad)
        optimizer.step()
        return {k: v.detach() for k, v in terms.items()}

    return train_step


@dataclasses.dataclass
class Trainer:
    """Epoch loop: train → checkpoint → eval, on one device.

    ``model`` is a :class:`~multihmr_tpu_torch.models.multihmr.MultiHMR`
    whose ``net`` the optimizer updates. ``data_iter_fn()`` yields batches
    of :data:`BATCH_KEYS` (numpy or tensors; moved to the net's device).
    """

    model: Any
    optimizer: torch.optim.Optimizer
    weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    checkpoint_dir: Optional[str] = None
    nb_max_ckpt: int = 3
    log_fn: Callable[[str], None] = print
    # GT body model for prepare_gt; None reuses the model's
    gt_body_model: Optional[BodyModel] = None
    clip_grad: float = 0.0
    # Abort after this many CONSECUTIVE steps whose raw loss terms are not
    # finite: nan_to_num would otherwise report a NaN'd model as loss 0
    # forever. A single bad batch only warns. 0 disables.
    nan_abort_steps: int = 8
    # Save the full train state (model, optimizer, epoch) every epoch under
    # checkpoint_dir/state, for restore()
    save_train_state: bool = True
    # Fetch the losses once per window of this many steps (one device-to-host
    # transfer and sync per window, so the host can run ahead of the card
    # between them); 1 syncs every step
    sync_every: int = 8
    # Mid-epoch progress print period in steps, rounded up to the window; 0
    # prints the epoch summary only
    log_every_steps: int = 0

    def __post_init__(self):
        self.train_step = make_train_step(
            self.model, self.optimizer, self.weights, gt_body_model=self.gt_body_model,
            person_center=self.model.cfg.person_center, clip_grad=self.clip_grad)

    def restore(self) -> Optional[int]:
        """Load the newest full train state saved by :meth:`fit` into the
        model and the optimizer; returns the next epoch, or None (and loads
        nothing) when no state exists."""
        if self.checkpoint_dir is None:
            return None
        state = ckpt.latest_train_state(self.checkpoint_dir)
        if state is None:
            return None
        self.model.net.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        return state["epoch"] + 1

    def fit(self, data_iter_fn: Callable[[], Any], epochs: int = 1,
            eval_fn: Optional[Callable[[Any, int], Any]] = None,
            start_epoch: int = 0) -> None:
        device = next(self.model.net.parameters()).device
        sync = max(int(self.sync_every), 1)
        for epoch in range(start_epoch, epochs):
            n, running = 0, 0.0
            # data-iterator time vs whole-step time, per sync window (between
            # fetches the steps run ahead of the card)
            meters = {k: AverageMeter(k) for k in ("data", "batch", "ratio_data")}
            pending = []  # device-side (total, finite) pairs awaiting one fetch
            data_win, win_n = 0.0, 0
            nan_streak = 0
            last_log = 0
            t_end = t_win = time.perf_counter()

            def _drain():
                nonlocal running, data_win, win_n, t_win, nan_streak
                if not pending:
                    return
                totals, flags = torch.stack([torch.stack(p) for p in pending]).cpu().unbind(1)
                running += float(totals.double().sum())
                pending.clear()
                for f in flags.tolist():
                    nan_streak = 0 if f > 0 else nan_streak + 1
                if flags.min() == 0:
                    self.log_fn(f"WARNING: {int((flags == 0).sum())}/{len(flags)} steps "
                                f"in this window had non-finite loss terms "
                                f"(masked to 0 by nan_to_num)")
                if self.nan_abort_steps and nan_streak >= self.nan_abort_steps:
                    raise RuntimeError(
                        f"{nan_streak} consecutive steps with non-finite loss terms: "
                        f"the parameters are almost certainly NaN and nan_to_num is "
                        f"masking it as loss 0; aborting. Lower the lr or clip gradients.")
                wall = time.perf_counter() - t_win
                meters["data"].update(data_win / win_n, n=win_n)
                meters["batch"].update(wall / win_n, n=win_n)
                meters["ratio_data"].update(data_win / max(wall, 1e-9), n=win_n)
                data_win, win_n = 0.0, 0
                t_win = time.perf_counter()

            for batch in data_iter_fn():
                t_data = time.perf_counter() - t_end
                terms = self.train_step(to_device(batch, device), epoch)
                pending.append((terms["total"], terms["finite"]))
                data_win += t_data
                win_n += 1
                n += 1
                if len(pending) >= sync:
                    _drain()
                    if self.log_every_steps and n - last_log >= self.log_every_steps:
                        last_log = n
                        self.log_fn(f"epoch {epoch} [{n}]: loss {running / n:.4f}")
                t_end = time.perf_counter()
            _drain()
            self.log_fn(
                f"epoch {epoch}: mean loss {running / max(n, 1):.4f} over {n} steps "
                f"(data {meters['data'].avg * 1e3:.1f} ms, "
                f"batch {meters['batch'].avg * 1e3:.1f} ms, "
                f"ratio_data {meters['ratio_data'].avg:.3f})")
            if self.checkpoint_dir is not None:
                sd = self.model.net.state_dict()
                ckpt.save_checkpoint(self.checkpoint_dir, sd, epoch, self.model.cfg)
                ckpt.prune_checkpoints(self.checkpoint_dir, self.nb_max_ckpt)
                if self.save_train_state:
                    ckpt.save_train_state(self.checkpoint_dir, epoch, sd,
                                          self.optimizer.state_dict(), self.nb_max_ckpt)
            if eval_fn is not None:
                eval_fn(self.model, epoch)
