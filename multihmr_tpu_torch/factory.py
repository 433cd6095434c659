"""Build a ready-to-run MultiHMR (``multihmr_tpu/factory.py``).

The six SMPL-X configurations of ``named_config``. With a reference
``multiHMR_*.pt`` (``checkpoint``) the weights are the file's, converted by
``io/checkpoint.py::convert_reference_checkpoint``. Without one they are
random, drawn on the CPU from ``torch.Generator().manual_seed(seed)`` so
that one seed gives the same weights whatever the device, then moved to
``device``. The Anny family waits for ROADMAP M8. The body model is the licensed SMPL-X neutral asset when it is
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


def smplx_dir() -> str:
    return os.environ.get("SMPLX_DIR", "models")


def smplx_asset() -> Optional[str]:
    """Path of the licensed SMPL-X neutral npz, or None when it is absent."""
    d = smplx_dir()
    for cand in (os.path.join(d, "smplx", "SMPLX_NEUTRAL.npz"),
                 os.path.join(d, "SMPLX_NEUTRAL.npz")):
        if os.path.exists(cand):
            return cand
    return None


def load_body_model(device, num_betas: int = 10) -> BodyModel:
    """The SMPL-X neutral asset if present, else the synthetic stand-in."""
    path = smplx_asset()
    if path is not None:
        return BodyModel.from_arrays(load_smplx_npz(path, num_betas=num_betas), device)
    return BodyModel.from_arrays(smplx_like_synthetic(num_betas), device)


def build_model(name: str = "multiHMR_896_L", device="cuda", seed: int = 0,
                cfg: Optional[ModelConfig] = None, tp_mode: str = "heads",
                checkpoint=None) -> MultiHMR:
    """MultiHMR for a named SMPL-X configuration on ``device``, with the
    weights of a reference ``checkpoint`` (path or loaded dict) or else
    seeded random ones. ``cfg`` overrides the named configuration;
    ``tp_mode`` "ring" runs the ViT's standard stream (K5), "heads" the
    channels-major one (K1, K2)."""
    if cfg is None:
        if "anny" in name:
            raise KeyError(f"{name!r}: the Anny family is not ported yet (ROADMAP M8)")
        if name not in SMPLX_NAMES:
            raise KeyError(f"{name!r} is not a ported configuration; known: {SMPLX_NAMES}")
        cfg = named_config(name)
    device = torch.device(device)
    if checkpoint is None:
        net = MultiHMRNet(cfg, tp_mode=tp_mode).init_weights(torch.Generator().manual_seed(seed))
    else:
        from multihmr_tpu_torch.io.checkpoint import convert_reference_checkpoint

        state = convert_reference_checkpoint(checkpoint, cfg)
        with torch.device("meta"):  # no init: every tensor comes from the file
            net = MultiHMRNet(cfg, tp_mode=tp_mode)
        net.load_state_dict(state, strict=True, assign=True)
    bm = load_body_model(device, cfg.num_betas)
    return MultiHMR(cfg, bm, net=net.to(device).eval())
