"""Build a ready-to-run MultiHMR (``multihmr_tpu/factory.py``).

The six SMPL-X configurations of ``named_config``. Without a checkpoint the
weights are random, drawn on the CPU from ``torch.Generator().manual_seed(seed)``
so that one seed gives the same weights whatever the device, then moved to
``device``. The body model is the licensed SMPL-X neutral asset when it is
present under ``$SMPLX_DIR`` (default ``models``), else the synthetic
stand-in with SMPL-X's dimensions.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from multihmr_tpu_torch.config import ModelConfig, named_config
from multihmr_tpu_torch.bodymodel.assets import load_smplx_npz, smplx_like_synthetic
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet

SMPLX_NAMES = (
    "multiHMR_896_L", "multiHMR_672_L", "multiHMR_672_B", "multiHMR_672_S",
    "multiHMR_1288_L_bedlam", "multiHMR_1288_L_agora",
)


def load_body_model(device, num_betas: int = 10) -> BodyModel:
    """The SMPL-X neutral asset if present, else the synthetic stand-in."""
    d = os.environ.get("SMPLX_DIR", "models")
    for cand in (os.path.join(d, "smplx", "SMPLX_NEUTRAL.npz"),
                 os.path.join(d, "SMPLX_NEUTRAL.npz")):
        if os.path.exists(cand):
            return BodyModel.from_arrays(load_smplx_npz(cand, num_betas=num_betas), device)
    return BodyModel.from_arrays(smplx_like_synthetic(num_betas), device)


def build_model(name: str = "multiHMR_896_L", device="cuda", seed: int = 0,
                cfg: Optional[ModelConfig] = None) -> MultiHMR:
    """MultiHMR for a named SMPL-X configuration, with seeded random weights,
    on ``device``. ``cfg`` overrides the named configuration."""
    if cfg is None:
        if name not in SMPLX_NAMES:
            raise KeyError(f"{name!r} is not a ported configuration; known: {SMPLX_NAMES}")
        cfg = named_config(name)
    device = torch.device(device)
    net = MultiHMRNet(cfg).init_weights(torch.Generator().manual_seed(seed))
    bm = load_body_model(device, cfg.num_betas)
    return MultiHMR(cfg, bm, net=net.to(device).eval())
