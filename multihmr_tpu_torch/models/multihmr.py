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

import copy
import dataclasses
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
from multihmr_tpu_torch.utils.profiling import span

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

    def __init__(self, cfg: ModelConfig, tp_mode: str = "heads", mesh=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.vit.embed_dim
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.backbone = DINOv2ViT(cfg.vit, cfg.grid_size, self.compute_dtype,
                                  remat_policy=cfg.remat_policy if cfg.remat else None,
                                  tp_mode=tp_mode, mesh=mesh)
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

        with span("vit"):
            z = self.backbone(x)["patch_tokens"]  # [B, N, D] in compute dtype

        with span("head"):
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
            dist = undo_focal_length_normalization(dist_raw, focal, fovn=c.fovn,
                                                   img_size=c.img_size)
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
    ``out['det'].valid`` the person mask. ``tp_mode`` picks the ViT's stream
    for a net built here: "heads" the channels-major one, "ring" the
    standard one. ``mesh`` (a (data, model) ``DeviceMesh``,
    parallel/sharding.py) shards the ViT over its ``model`` axis, heads or
    sequence by ``tp_mode``: the net's weights are then this rank's shards
    (``shard_state_dict``) and ``x`` this rank's slice of the batch. The
    batch is one fused forward, with or without a mesh (the JAX package's
    ``batch_mode="map"`` is not ported)."""

    def __init__(self, cfg: ModelConfig, body_model: BodyModel,
                 net: Optional[MultiHMRNet] = None, person_center_joint_names=None,
                 tp_mode: str = "heads", mesh=None):
        self.cfg = cfg
        self.body_model = body_model
        self.net = net if net is not None else MultiHMRNet(cfg, tp_mode=tp_mode, mesh=mesh)
        self.mesh = mesh
        self.tp_mode = "heads" if self.net.backbone.transposed else "ring"  # the net's own
        self.smpl_layer = SMPLXCameraLayer(
            body_model, person_center=cfg.person_center, joint_names=person_center_joint_names)

    def forward(self, x, K, det_thresh: float = 0.3, nms_kernel_size: int = 3,
                is_training: bool = False, gt_det: Optional[Detections] = None) -> dict:
        out = self.net(x, K, det_thresh=det_thresh, nms_kernel_size=nms_kernel_size,
                       is_training=is_training, gt_det=gt_det)
        return self.apply_body_model(out, K)

    def replica(self, device) -> "MultiHMR":
        """This model on ``device``: itself where it is already there, else a
        copy of its weights (their dtypes kept) and body model there."""
        device = torch.device(device)
        if device == self.body_model.v_template.device:
            return self
        if self.mesh is not None:
            raise ValueError("replica() copies a single-device model, not a rank's shards")
        twin = copy.copy(self)
        twin.body_model = moved(self.body_model, device)
        twin.smpl_layer = copy.copy(self.smpl_layer)
        twin.smpl_layer.model = twin.body_model
        twin.net = net_copy(self.net, MultiHMRNet, self.cfg, self.tp_mode, device)
        return twin

    def unsharded(self) -> "MultiHMR":
        """A single-device twin (no mesh) of this model on this rank's
        device, sharing its body model; its net's weights are uninitialised:
        load a full state dict into it."""
        twin = copy.copy(self)
        device = self.body_model.v_template.device
        twin.net = MultiHMRNet(self.cfg, tp_mode=self.tp_mode).to(device)
        twin.mesh = None
        return twin

    def apply_body_model(self, out: dict, K) -> dict:
        """Run the body model on all ``B*K`` slots and merge v3d, j3d, j2d,
        v2d, transl and transl_pelvis into ``out``."""
        B, Kcap = out["rotvec"].shape[:2]
        flat = lambda t: t.reshape((B * Kcap,) + t.shape[2:])
        K_det = K[:, None].expand(B, Kcap, 3, 3).reshape(B * Kcap, 3, 3)
        with span("body"):
            smpl_out = self.smpl_layer(
                flat(out["rotvec"]), flat(out["shape"]), flat(out["loc"]),
                flat(out["dist"]), K_det, expression=flat(out["expression"]))
        out = dict(out)
        out.update({k: v.reshape((B, Kcap) + v.shape[1:]) for k, v in smpl_out.items()})
        return out

    def extract_persons(self, out: dict, fields: Optional[list] = None) -> list:
        """Padded ``[B, K]`` outputs → per-image lists of person dicts of numpy
        arrays. ``fields`` restricts which keys are read back to the host
        (default: all)."""
        valid = out["det"].valid.cpu().numpy()
        # valid slots are a prefix of K: read back only [:, :kmax]
        kmax = int(valid.sum(-1).max())
        host = {name: out[src][:, :kmax].cpu().numpy() for name, src in _person_keys(fields)}
        return persons_from_host({"valid": valid, **host})

    def start_persons(self, out: dict, fields: Optional[list] = None) -> "Readback":
        """Enqueue the device→host copies of :meth:`extract_persons` (every
        slot of each field, so nothing waits for the count of valid ones) and
        return at once; ``.persons()`` waits for them and builds the lists."""
        tensors = {"valid": out["det"].valid,
                   **{name: out[src] for name, src in _person_keys(fields)}}
        return Readback(tensors, persons_from_host)


def moved(model, device):
    """A copy of the frozen dataclass ``model`` (a body model) with its
    tensors, and those of its dataclass fields, on ``device``."""
    kw = {}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            kw[f.name] = moved(v, device)
    return dataclasses.replace(model, **kw)


def net_copy(net: nn.Module, net_cls, cfg, tp_mode: str, device) -> nn.Module:
    """A copy of ``net`` on ``device``: built on the meta device, its weights
    assigned from ``net``'s state dict (their dtypes kept), then moved, which
    brings the buffers outside the state dict along."""
    with torch.device("meta"):
        twin = net_cls(cfg, tp_mode=tp_mode)
    twin.load_state_dict({k: v.to(device) for k, v in net.state_dict().items()},
                         strict=True, assign=True)
    return twin.to(device).train(net.training)


# (person key, output key) of extract_persons, in its order
PERSON_FIELDS = (
    ("scores", "scores_det"), ("loc", "loc"), ("transl", "transl"),
    ("transl_pelvis", "transl_pelvis"), ("rotvec", "rotvec"),
    ("expression", "expression"), ("shape", "shape"),
    ("v3d", "v3d"), ("j3d", "j3d"), ("j2d", "j2d"),
)


def _person_keys(fields):
    return [(name, src) for name, src in PERSON_FIELDS if fields is None or name in fields]


def persons_from_host(host: dict) -> list:
    """Host arrays ``{"valid": [B, K], field: [B, k, ...]}`` (``k`` at most
    ``K``, at least the largest count of valid slots) → per-image lists of
    person dicts (the valid slots, a prefix of K)."""
    valid = host.pop("valid")
    B, K = valid.shape
    full = valid.sum(-1) == K
    if full.any():
        warnings.warn(
            f"{int(full.sum())} image(s) saturated the detection capacity "
            f"K={K}; people beyond it are dropped.", stacklevel=3)
    k = next(iter(host.values())).shape[1] if host else K
    return [[{name: a[b, i] for name, a in host.items()} for i in range(k) if valid[b, i] > 0]
            for b in range(B)]


class Readback:
    """A forward's persons on their way to the host: device→host copies of a
    dict of tensors, in flight, and ``build``, which turns the host arrays
    into the persons.

    On a CUDA device each tensor is copied into its own pinned host buffer
    with ``non_blocking=True`` on the current stream, and one event is
    recorded after the last copy: the host goes on (enqueueing the next
    forward, say) and :meth:`wait` blocks on that event alone, not on the
    stream, so later work on the stream does not delay it. On the CPU the
    copies are done at once."""

    def __init__(self, tensors: dict, build):
        first = next(iter(tensors.values()))
        cuda = first.device.type == "cuda"
        self.build = build
        self.host = {}
        for name, t in tensors.items():
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
            h.copy_(t, non_blocking=cuda)
            self.host[name] = h
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(first.device))

    def wait(self) -> dict:
        """Block until the copies landed; the host arrays, as numpy."""
        if self.event is not None:
            self.event.synchronize()
        return {name: h.numpy() for name, h in self.host.items()}

    def persons(self) -> list:
        """Wait for the copies; the per-image lists of person dicts."""
        with span("readback"):
            return self.build(self.wait())
