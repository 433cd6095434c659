"""Multi-HMR: image → people as SMPL-X meshes (``multihmr_tpu/models/multihmr.py``).

image ``[B, S, S, 3]`` → ViT patch tokens → per-patch detection scores
(clamped sigmoid, max-pool NMS, fixed-capacity top-K) → central features and
2D offsets → camera-ray Fourier embedding → HPH cross-attention → SMPL-X
parameters and distance → camera-aware body model → meshes, all as ``[B, K]``
slots with the valid ones first.

Precision: the ViT and the detection MLP in ``cfg.compute_dtype``; geometry,
the HPH head and the body model in fp32.

Training: ``is_training=True`` with ``gt_det`` (the ground-truth detection
slots of ``train/trainer.py::prepare_gt``) replaces NMS and top-K. Nothing
in the network depends on ``nn.Module.train()``/``eval()``: no dropout, no
batch statistics.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multihmr_tpu_torch.config import ModelConfig
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.models.hph import HPH, init_linear_
from multihmr_tpu_torch.models.smplx_layer import SMPLXCameraLayer
from multihmr_tpu_torch.models.vit import DINOv2ViT
from multihmr_tpu_torch.ops.camera import (
    inverse_perspective_projection,
    undo_focal_length_normalization,
    undo_log_depth,
)
from multihmr_tpu_torch.ops.detection import (
    Detections,
    clamped_sigmoid,
    gather_grid,
    nms_maxpool,
    topk_detect,
)
from multihmr_tpu_torch.ops.fourier import fourier_ray_features
from multihmr_tpu_torch.ops.image import tokens_to_grid
from multihmr_tpu_torch.ops.rotations import rotmat_to_rotvec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class RegressionMLP(nn.Module):
    """Linear-ReLU-Linear, computed in the input's dtype."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc0 = nn.Linear(dim, hidden)
        self.fc1 = nn.Linear(hidden, out)

    def forward(self, x):
        dt = x.dtype
        x = F.relu(F.linear(x, self.fc0.weight.to(dt), self.fc0.bias.to(dt)))
        return F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt))


class MultiHMRNet(nn.Module):
    """Backbone + detection + HPH: everything but the body model."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.vit.embed_dim
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.backbone = DINOv2ViT(cfg.vit, cfg.grid_size, self.compute_dtype,
                                  remat_policy=cfg.remat_policy if cfg.remat else None)
        self.mlp_classif = RegressionMLP(d, d, 1)
        self.mlp_offset = RegressionMLP(d, d, 2)
        self.x_attention_head = HPH(cfg)

    def init_weights(self, generator: torch.Generator) -> "MultiHMRNet":
        """Seeded random init with the JAX package's initializers."""
        self.backbone.init_weights(generator)
        for mlp in (self.mlp_classif, self.mlp_offset):
            init_linear_(mlp.fc0, generator)
            init_linear_(mlp.fc1, generator)
        self.x_attention_head.init_weights(generator)
        return self

    def forward(self, x, K, det_thresh: float = 0.3, nms_kernel_size: int = 3,
                is_training: bool = False, gt_det: Optional[Detections] = None) -> dict:
        """``x [B, S, S, 3]`` normalized NHWC, ``K [B, 3, 3]``. Training takes
        the detections ``gt_det`` instead of NMS and top-K."""
        c = self.cfg
        B = x.shape[0]
        g = c.grid_size

        z = self.backbone(x)["patch_tokens"]  # [B, N, D] in compute dtype

        logits = self.mlp_classif(z)
        scores_grid = clamped_sigmoid(logits.float())[..., 0].reshape(B, g, g)
        if is_training:
            if gt_det is None:
                raise ValueError("training requires GT detections (gt_det)")
            det = gt_det
        else:
            det = topk_detect(nms_maxpool(scores_grid, nms_kernel_size), det_thresh,
                              c.max_people)
        flat_idx = det.rows * g + det.cols
        scores_det = torch.gather(scores_grid.reshape(B, -1), 1, flat_idx) * det.valid

        z_grid = tokens_to_grid(z.float(), g)
        z_central = gather_grid(z_grid, det)
        offset = self.mlp_offset(z_central)

        # patch-centre pixels in (row, col) order → unit-distance rays
        ar = torch.arange(g, device=x.device)
        rr, cc = torch.meshgrid(ar, ar, indexing="ij")
        pts = torch.stack([rr, cc], dim=-1).reshape(1, -1, 2).float()
        pts = (pts * c.patch_size + c.patch_size // 2).expand(B, g * g, 2)
        rays = inverse_perspective_projection(
            pts, K, torch.ones((B, g * g, 1), device=x.device))
        z_K = fourier_ray_features(
            rays, c.camera_embedding_num_bands, c.camera_embedding_max_resolution
        ).reshape(B, g, g, c.camera_embed_dim)

        z_central = torch.cat([z_central, gather_grid(z_K, det)], dim=-1)
        kv_grid = torch.cat([z_grid, z_K], dim=-1)

        loc = torch.stack([det.cols, det.rows], dim=-1).float()
        loc = (loc + 0.5 + offset) * c.patch_size

        head = self.x_attention_head(z_central, kv_grid, det)

        dist_raw = head["cam"][..., 0:1]
        focal = K[:, 0, 0][:, None, None]
        dist = undo_focal_length_normalization(dist_raw, focal, fovn=c.fovn, img_size=c.img_size)
        if c.nearness:
            dist = undo_log_depth(dist)
        if c.clip_dist:
            dist = torch.clamp(dist, 0.0, 50.0)

        rotmat = head["rotmat"]
        return {
            "scores": scores_grid,
            "scores_det": scores_det,
            "det": det,
            "offset": offset,
            "loc": loc,
            "dist": dist,
            "dist_postprocessed": dist_raw,
            "rotmat": rotmat,
            "rotvec": rotmat_to_rotvec(rotmat),
            "shape": head["betas"],
            "expression": head["expression"],
        }


class MultiHMR:
    """Network + body model. ``forward`` returns ``[B, K, ...]`` slots with
    ``out['det'].valid`` the person mask."""

    def __init__(self, cfg: ModelConfig, body_model: BodyModel,
                 net: Optional[MultiHMRNet] = None, person_center_joint_names=None):
        self.cfg = cfg
        self.body_model = body_model
        self.net = net if net is not None else MultiHMRNet(cfg)
        self.smpl_layer = SMPLXCameraLayer(
            body_model, person_center=cfg.person_center, joint_names=person_center_joint_names)

    def forward(self, x, K, det_thresh: float = 0.3, nms_kernel_size: int = 3,
                is_training: bool = False, gt_det: Optional[Detections] = None) -> dict:
        out = self.net(x, K, det_thresh=det_thresh, nms_kernel_size=nms_kernel_size,
                       is_training=is_training, gt_det=gt_det)
        return self.apply_body_model(out, K)

    def apply_body_model(self, out: dict, K) -> dict:
        """Run the body model on all ``B*K`` slots and merge v3d, j3d, j2d,
        v2d, transl and transl_pelvis into ``out``."""
        B, Kcap = out["rotvec"].shape[:2]
        flat = lambda t: t.reshape((B * Kcap,) + t.shape[2:])
        K_det = K[:, None].expand(B, Kcap, 3, 3).reshape(B * Kcap, 3, 3)
        smpl_out = self.smpl_layer(
            flat(out["rotvec"]), flat(out["shape"]), flat(out["loc"]),
            flat(out["dist"]), K_det, expression=flat(out["expression"]))
        out = dict(out)
        out.update({k: v.reshape((B, Kcap) + v.shape[1:]) for k, v in smpl_out.items()})
        return out

    def extract_persons(self, out: dict) -> list:
        """Padded ``[B, K]`` outputs → per-image lists of person dicts of numpy
        arrays."""
        valid = out["det"].valid.cpu().numpy()
        B = valid.shape[0]
        full = valid.sum(-1) == valid.shape[1]
        if full.any():
            warnings.warn(
                f"{int(full.sum())} image(s) saturated the detection capacity "
                f"K={valid.shape[1]}; people beyond it are dropped.", stacklevel=2)
        keys = [
            ("scores", "scores_det"), ("loc", "loc"), ("transl", "transl"),
            ("transl_pelvis", "transl_pelvis"), ("rotvec", "rotvec"),
            ("expression", "expression"), ("shape", "shape"),
            ("v3d", "v3d"), ("j3d", "j3d"), ("j2d", "j2d"),
        ]
        # valid slots are a prefix of K: read back only [:, :kmax]
        kmax = int(valid.sum(-1).max())
        if kmax == 0:
            return [[] for _ in range(B)]
        host = {name: out[src][:, :kmax].cpu().numpy() for name, src in keys}
        return [
            [{name: host[name][b, k] for name, _ in keys}
             for k in range(kmax) if valid[b, k] > 0]
            for b in range(B)
        ]

