"""Multi-HMR, Anny variant: the ``multiHMR_672_L_anny`` family
(``multihmr_tpu/models/multihmr_anny.py``).

image ``[B, S, S, 3]`` → ViT → per-patch detection scores (plain sigmoid,
max-pool NMS, fixed-capacity top-K) and the camera's FOV from the cls token
(``fov = π·sigmoid``, K from it) → decoder queries: projected patch features
plus a 2D sincos embedding at the detected cells, attending to the whole
grid → MLP heads for offset, 163 bone rotations (6d, column-pair layout),
phenotypes (sigmoid) and distance (``focal / exp(d)``) → the bones the model
does not control pinned to identity (``USEFUL_ROTMAT``) → the Anny body
model → meshes as ``[B, K]`` slots, valid ones first.

Precision: the ViT in ``cfg.compute_dtype``; the heads, the decoder and the
body model in fp32. The spans (``utils/profiling.py::span``) are
``models/multihmr.py``'s: ``multihmr.vit`` around the backbone,
``multihmr.head`` around the rest of the net with ``multihmr.decoder``
inside it, and ``multihmr.body`` around the body model (which holds
``multihmr.fk``). ``replica``, ``extract_persons`` and ``start_persons``
keep ``MultiHMR``'s contract, so ``parallel/infer.py::folder_inference``
runs this family too. Inference only, as in the JAX package (no training
path calls it, so its ``is_training``/``gt_det`` arguments are not ported);
``batch_mode="map"`` is not ported either (the batch is one fused forward).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from multihmr_tpu_torch.config import ViTConfig
from multihmr_tpu_torch.bodymodel.anny import NUM_BONES, USED_PHENOTYPES, AnnyModel, anny_forward
from multihmr_tpu_torch.models.hph import (
    FeedForward,
    MaskedCrossAttention,
    MaskedSelfAttention,
    init_linear_,
)
from multihmr_tpu_torch.models.multihmr import DTYPES, Readback, RegressionMLP, moved, net_copy
from multihmr_tpu_torch.models.vit import DINOv2ViT
from multihmr_tpu_torch.ops.camera import inverse_perspective_projection, perspective_projection
from multihmr_tpu_torch.ops.detection import gather_grid, nms_maxpool, topk_detect
from multihmr_tpu_torch.ops.image import grid_to_tokens, tokens_to_grid
from multihmr_tpu_torch.ops.posenc import get_2d_sincos_pos_embed
from multihmr_tpu_torch.ops.rotations import (
    rot6d_cols_to_rotmat,
    rotation_to_homogeneous,
    rotmat_to_rotvec,
)
from multihmr_tpu_torch.utils.profiling import span

# which of the 163 bone rotations are regressed (1) or pinned to identity (0)
USEFUL_ROTMAT = np.array(
    [1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0],
    dtype=np.float32,
)


@dataclasses.dataclass(frozen=True)
class AnnyConfig:
    """The Anny family's configuration, field for field the JAX package's."""

    backbone: str = "dinov2_vitl14"
    img_size: int = 672
    xat_dim: int = 512
    xat_depth: int = 8
    xat_heads: int = 16
    xat_dim_head: int = 32
    xat_mlp_dim: int = 4 * 512
    person_center: str = "head"
    num_betas: int = 11
    n_joints: int = NUM_BONES
    max_people: int = 16
    compute_dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: str = "block"
    vit_override: Optional[ViTConfig] = None

    @property
    def vit(self) -> ViTConfig:
        if self.vit_override is not None:
            return self.vit_override
        from multihmr_tpu_torch.config import _BACKBONES

        return _BACKBONES[self.backbone]

    @property
    def patch_size(self) -> int:
        return self.vit.patch_size

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size


def _default_init_pose(n_joints: int) -> np.ndarray:
    """``[1, n_joints * 6]``: the root at rotvec [π/2, 0, 0], i.e.
    R = [[1, 0, 0], [0, 0, -1], [0, 1, 0]], the other bones at identity, in
    the column-pair 6d layout."""
    root_R = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    root6d = root_R[:, :2].reshape(-1)
    eye6d = np.eye(3, dtype=np.float32)[:, :2].reshape(-1)
    return np.concatenate([root6d, np.tile(eye6d, n_joints - 1)]).reshape(1, -1)


class AnnyEncoder(nn.Module):
    """ViT, per-patch detection logits, and K from the regressed FOV."""

    def __init__(self, cfg: AnnyConfig, tp_mode: str = "heads", mesh=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.vit.embed_dim
        self.backbone = DINOv2ViT(cfg.vit, cfg.grid_size, DTYPES[cfg.compute_dtype],
                                  remat_policy=cfg.remat_policy if cfg.remat else None,
                                  tp_mode=tp_mode, mesh=mesh)
        self.mlp_det = RegressionMLP(d, d, 1)
        self.mlp_fov_unique = RegressionMLP(d, d, 1)

    def forward(self, x) -> dict:
        return self.read(self.backbone(x))

    def read(self, out: dict) -> dict:
        """The backbone's outputs → scores, K and FOV, and the feature grid."""
        c = self.cfg
        feat = tokens_to_grid(out["patch_tokens"].float(), c.grid_size)  # [B, g, g, D]
        scores_logits = self.mlp_det(feat)[..., 0]
        fov = math.pi * torch.sigmoid(self.mlp_fov_unique(out["cls_token"].float()))  # [B, 1]
        focal = (c.img_size / 2.0) / torch.tan(fov / 2.0)
        K = torch.zeros((feat.shape[0], 3, 3), device=feat.device)
        K[:, 0, 0] = K[:, 1, 1] = focal[:, 0]
        K[:, 0, 2] = K[:, 1, 2] = c.img_size / 2.0
        K[:, 2, 2] = 1.0
        return {"scores_logits": scores_logits, "scores": torch.sigmoid(scores_logits),
                "K": K, "fov": fov, "feat": feat}


class AnnyHPH(nn.Module):
    """Masked self-attention, cross-attention and feed-forward layers, fp32."""

    def __init__(self, cfg: AnnyConfig):
        super().__init__()
        self.depth = cfg.xat_depth
        d = cfg.xat_dim
        for i in range(cfg.xat_depth):
            setattr(self, f"sa_norm{i}", nn.LayerNorm(d, eps=1e-5))
            setattr(self, f"sa{i}", MaskedSelfAttention(d, cfg.xat_heads, cfg.xat_dim_head))
            setattr(self, f"ca_norm{i}", nn.LayerNorm(d, eps=1e-5))
            setattr(self, f"ca{i}", MaskedCrossAttention(d, d, cfg.xat_heads, cfg.xat_dim_head))
            setattr(self, f"ff_norm{i}", nn.LayerNorm(d, eps=1e-5))
            setattr(self, f"ff{i}", FeedForward(d, cfg.xat_mlp_dim))

    def forward(self, queries, context, mask):
        x = queries
        m = mask[..., None]
        for i in range(self.depth):
            y = getattr(self, f"sa_norm{i}")(x * m)
            x = getattr(self, f"sa{i}")(y, mask) + x * m
            y = getattr(self, f"ca_norm{i}")(x)
            x = getattr(self, f"ca{i}")(y, context, mask) + x
            y = getattr(self, f"ff_norm{i}")(x)
            x = getattr(self, f"ff{i}")(y) + x
        return x * m


class MultiHMRAnnyNet(nn.Module):
    """Encoder, decoder and heads: everything but the body model.

    ``dec_pos_emb [g, g, xat_dim]`` and ``init_body_pose [1, n_joints * 6]``
    are persistent buffers (the JAX package's ``constants``): a reference
    checkpoint carries both, and its ``init_body_pose`` need not be
    :func:`_default_init_pose`."""

    def __init__(self, cfg: AnnyConfig, tp_mode: str = "heads", mesh=None):
        super().__init__()
        self.cfg = cfg
        X, J, g = cfg.xat_dim, cfg.n_joints, cfg.grid_size
        self.encoder = AnnyEncoder(cfg, tp_mode=tp_mode, mesh=mesh)
        self.dec_to_token = nn.Linear(cfg.vit.embed_dim, X)
        self.decoder = AnnyHPH(cfg)
        self.mlp_offset = RegressionMLP(X, X, 2)
        self.mlp_pose = RegressionMLP(X + J * 6, X, J * 6)
        self.mlp_shape = RegressionMLP(X, X, cfg.num_betas)
        self.mlp_dist = RegressionMLP(X, X, 1)
        self.register_buffer("dec_pos_emb", torch.as_tensor(
            get_2d_sincos_pos_embed(X, g), dtype=torch.float32).reshape(g, g, X))
        self.register_buffer("init_body_pose", torch.as_tensor(_default_init_pose(J)))
        # not in the state dict: on the CPU even in a meta-device build
        self.register_buffer("useful_rotmat", torch.as_tensor(
            USEFUL_ROTMAT[:J], device="cpu").reshape(1, 1, J, 1, 1), persistent=False)

    def init_weights(self, generator: torch.Generator) -> "MultiHMRAnnyNet":
        """Seeded random init with the JAX package's initializers."""
        self.encoder.backbone.init_weights(generator)
        for part in (self.encoder.mlp_det, self.encoder.mlp_fov_unique, self.dec_to_token,
                     self.decoder, self.mlp_offset, self.mlp_pose, self.mlp_shape,
                     self.mlp_dist):
            for m in part.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
        return self

    def forward(self, x, K=None, det_thresh: float = 0.3, nms_kernel_size: int = 3) -> dict:
        """``x [B, S, S, 3]`` normalized NHWC; ``K [B, 3, 3]``, or None to use
        the regressed one."""
        with span("vit"):
            tokens = self.encoder.backbone(x)
        with span("head"):
            return self._head(self.encoder.read(tokens), K, det_thresh, nms_kernel_size)

    def _head(self, enc: dict, K, det_thresh: float, nms_kernel_size: int) -> dict:
        c = self.cfg
        K_used = enc["K"] if K is None else K
        det = topk_detect(nms_maxpool(enc["scores"], nms_kernel_size), det_thresh, c.max_people)

        dec_emb = self.dec_to_token(enc["feat"]) + self.dec_pos_emb[None]
        with span("decoder"):
            y = self.decoder(gather_grid(dec_emb, det), grid_to_tokens(dec_emb), det.valid)

        offset = self.mlp_offset(y)
        loc = torch.stack([det.cols, det.rows], dim=-1).float()
        loc = (loc + 0.5 + offset) * c.patch_size

        focal = K_used[:, 0, 0][:, None, None]
        d_raw = self.mlp_dist(y)
        dist = focal / torch.clamp(torch.exp(d_raw), min=1e-5)
        transl = inverse_perspective_projection(loc, K_used, dist)

        shape = torch.sigmoid(self.mlp_shape(y))

        (B, Kcap), J = y.shape[:2], c.n_joints
        init_pose = self.init_body_pose
        rot6d = self.mlp_pose(torch.cat([y, init_pose.expand(B, Kcap, J * 6)], dim=-1))
        rotmat = rot6d_cols_to_rotmat((rot6d + init_pose).reshape(B, Kcap, J, 6))
        useful = self.useful_rotmat
        rotmat = useful * rotmat + (1.0 - useful) * torch.eye(3, device=y.device)

        return {
            "det": det,
            "scores": enc["scores"],
            "scores_logits": enc["scores_logits"],
            "K": K_used,
            "K_regressed": enc["K"],
            "fov_regressed": enc["fov"],
            "feat": enc["feat"],
            "loc": loc,
            "offset": offset,
            "dist": dist,
            "dist_postprocessed": d_raw,
            "shape": shape,
            "rotmat": rotmat,
            "rotvec": rotmat_to_rotvec(rotmat),
            "transl": transl,
        }


class MultiHMRAnny:
    """Network + Anny body model. ``forward`` returns ``[B, K, ...]`` slots
    with ``out['det'].valid`` the person mask. Meshes are re-centred on the
    bone labelled ``cfg.person_center``. ``mesh``: the ViT's attention
    sharded over the mesh's ``model`` axis (``tp_mode`` "heads" or "ring",
    models/vit.py), the net's weights this rank's shards
    (``parallel.sharding.shard_state_dict``); the batch is this rank's."""

    def __init__(self, cfg: AnnyConfig, body_model: AnnyModel,
                 net: Optional[MultiHMRAnnyNet] = None, tp_mode: str = "heads", mesh=None):
        self.cfg = cfg
        self.body_model = body_model
        self.net = net if net is not None else MultiHMRAnnyNet(cfg, tp_mode=tp_mode, mesh=mesh)
        self.mesh = mesh
        self.tp_mode = "heads" if self.net.encoder.backbone.transposed else "ring"
        self.person_center_idx = body_model.person_center_index(cfg.person_center)
        self._pheno_idx = body_model.used_phenotype_indices()

    def forward(self, x, K=None, det_thresh: float = 0.3, nms_kernel_size: int = 3) -> dict:
        out = self.net(x, K, det_thresh=det_thresh, nms_kernel_size=nms_kernel_size)
        return self.apply_body_model(out)

    def replica(self, device) -> "MultiHMRAnny":
        """This model on ``device``: itself where it is already there, else a
        copy of its weights (their dtypes kept) and body model there."""
        device = torch.device(device)
        if device == self.body_model.v_template.device:
            return self
        if self.mesh is not None:
            raise ValueError("replica() copies a single-device model, not a rank's shards")
        twin = copy.copy(self)
        twin.body_model = moved(self.body_model, device)
        twin.net = net_copy(self.net, MultiHMRAnnyNet, self.cfg, self.tp_mode, device)
        return twin

    def apply_body_model(self, out: dict) -> dict:
        """Run the body model on all ``B*K`` slots, re-centre each mesh on
        its person-centre bone at ``transl``, and project with ``out['K']``."""
        B, Kcap = out["rotmat"].shape[:2]
        flat = lambda t: t.reshape((B * Kcap,) + t.shape[2:])  # noqa: E731
        unflat = lambda t: t.reshape((B, Kcap) + t.shape[1:])  # noqa: E731
        with span("body"):
            shape = flat(out["shape"])
            phen = {name: shape[:, i] for name, i in zip(USED_PHENOTYPES, self._pheno_idx)}
            body = anny_forward(self.body_model, rotation_to_homogeneous(flat(out["rotmat"])),
                                phen)
            c = self.person_center_idx
            center = body["joints"][:, c:c + 1]
            transl = flat(out["transl"])[:, None]
            v3d = body["vertices"] - center + transl
            j3d = body["joints"] - center + transl
            K_det = out["K"][:, None].expand(B, Kcap, 3, 3).reshape(B * Kcap, 3, 3)
            v2d = perspective_projection(v3d, K_det)
            j2d = perspective_projection(j3d, K_det)
        out = dict(out)
        out.update({
            "v3d": unflat(v3d), "j3d": unflat(j3d), "v2d": unflat(v2d), "j2d": unflat(j2d),
            "transl_pelvis": unflat(j3d[:, :1]),
            "blendshape_coeffs": unflat(body["blendshape_coeffs"]),
        })
        return out

    def extract_persons(self, out: dict, fields: Optional[list] = None) -> list:
        """Padded ``[B, K]`` outputs → per-image lists of person dicts of
        numpy arrays, sorted near to far, each with the image's ``K``,
        ``K_regressed`` and ``fov``. ``fields`` restricts which keys are read
        back to the host (default: all); the depth that orders the persons
        is read back whatever ``fields`` holds."""
        valid = out["det"].valid.cpu().numpy()
        # valid slots are a prefix of K: read back only [:, :kmax]
        kmax = int(valid.sum(-1).max())
        host = {name: (t if name in _IMAGE_NAMES else t[:, :kmax]).cpu().numpy()
                for name, t in _anny_keys(out, fields).items()}
        return _anny_persons_from_host(dict(host, valid=valid))

    def start_persons(self, out: dict, fields: Optional[list] = None) -> Readback:
        """Enqueue :meth:`extract_persons`' device→host copies (every slot)
        and return at once; ``.persons()`` waits for them."""
        return Readback(dict(_anny_keys(out, fields), valid=out["det"].valid),
                        _anny_persons_from_host)


# (person key, output key) of extract_persons: a field per slot, then per image
_PERSON_FIELDS = (("loc", "loc"), ("transl", "transl"), ("transl_pelvis", "transl_pelvis"),
                  ("rotvec", "rotvec"), ("rotmat", "rotmat"), ("shape", "shape"),
                  ("v3d", "v3d"), ("j3d", "j3d"), ("j2d", "j2d"))
_IMAGE_FIELDS = (("K", "K"), ("K_regressed", "K_regressed"), ("fov", "fov_regressed"))
_IMAGE_NAMES = {name for name, _ in _IMAGE_FIELDS}


def _anny_keys(out: dict, fields) -> dict:
    """{host name: output tensor} to read back for ``fields`` (None: all),
    with ``depth``, the slots' distances along the optical axis."""
    keys = {name: out[src] for name, src in _PERSON_FIELDS + _IMAGE_FIELDS
            if fields is None or name in fields}
    keys["depth"] = out["transl"][..., 2]
    return keys


def _anny_persons_from_host(host: dict) -> list:
    """Host arrays (``valid`` ``[B, K]``, ``depth`` and the person fields
    ``[B, k, ...]`` with ``k`` at least the largest count of valid slots,
    the image fields ``[B, ...]``) → per-image lists of persons, near to
    far."""
    valid, depth = host.pop("valid"), host.pop("depth")
    result = []
    for b in range(valid.shape[0]):
        slots = sorted((i for i in range(depth.shape[1]) if valid[b, i] > 0),
                       key=lambda i: float(depth[b, i]))
        result.append([{name: a[b] if name in _IMAGE_NAMES else a[b, i]
                        for name, a in host.items()} for i in slots])
    return result
