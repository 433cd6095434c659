"""Build a ready-to-run MultiHMR (``multihmr_tpu/factory.py``).

The six SMPL-X configurations of ``named_config``, the port-only SMPL-X
configuration ``multiHMR_896_G`` (DINOv2 ViT-g/14, ``port_config.py``), and
the Anny family (a name holding "anny": ``anny_config``, ``MultiHMRAnny``). With a reference
``multiHMR_*.pt`` (``checkpoint``) the weights are the file's, converted by
``io/checkpoint.py::convert_reference_checkpoint`` (``_anny``). Without one
they are random, drawn on the CPU from ``torch.Generator().manual_seed(seed)``
so that one seed gives the same weights whatever the device, then moved to
``device``. The SMPL-X body model is the licensed neutral asset when it is
present under ``$SMPLX_DIR`` (default ``models``), else the synthetic
stand-in with SMPL-X's dimensions; the Anny one is ``$ANNY_NPZ``, else
``$SMPLX_DIR/anny.npz`` (``tools/convert_anny.py`` writes it), else
``synthetic_anny_model()``. :func:`build_host_model` gives the weightless
model that serves an exported artifact.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from multihmr_tpu_torch.config import named_config
from multihmr_tpu_torch.bodymodel.anny import AnnyModel, load_anny_npz, synthetic_anny_model
from multihmr_tpu_torch.bodymodel.assets import load_smplx_npz, smplx_like_synthetic
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from multihmr_tpu_torch.models.multihmr_anny import AnnyConfig, MultiHMRAnny, MultiHMRAnnyNet
from multihmr_tpu_torch.port_config import CONFIGS as PORT_CONFIGS

SMPLX_NAMES = (
    "multiHMR_896_L", "multiHMR_672_L", "multiHMR_672_B", "multiHMR_672_S",
    "multiHMR_1288_L_bedlam", "multiHMR_1288_L_agora",
) + tuple(PORT_CONFIGS)


def smplx_config(name: str):
    """The configuration of an SMPL-X name: ``named_config``'s, or the
    port's own (``port_config.CONFIGS``)."""
    if name not in SMPLX_NAMES:
        raise KeyError(f"{name!r} is not a ported configuration; known: {SMPLX_NAMES}")
    return PORT_CONFIGS[name] if name in PORT_CONFIGS else named_config(name)


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


def anny_config(name: str) -> AnnyConfig:
    """The configuration of an Anny-family name (the JAX package's one)."""
    return AnnyConfig(backbone="dinov2_vitl14", img_size=672)


def load_anny_model(device) -> AnnyModel:
    """``$ANNY_NPZ``, else ``$SMPLX_DIR/anny.npz``, else the synthetic stand-in."""
    path = os.environ.get("ANNY_NPZ", os.path.join(smplx_dir(), "anny.npz"))
    arrays = load_anny_npz(path) if os.path.exists(path) else synthetic_anny_model()
    return AnnyModel.from_arrays(arrays, device)


def _net(net_cls, cfg, tp_mode: str, seed: int, state: Optional[dict]):
    """Seeded random weights, or ``state`` assigned into a meta-device build."""
    if state is None:
        return net_cls(cfg, tp_mode=tp_mode).init_weights(torch.Generator().manual_seed(seed))
    with torch.device("meta"):  # no init: every tensor comes from the file
        net = net_cls(cfg, tp_mode=tp_mode)
    net.load_state_dict(state, strict=True, assign=True)
    return net


def _on_mesh(net_cls, cfg, tp_mode: str, net, mesh):
    """This rank's net on ``mesh``: the full ``net``'s weights cut into the
    rank's shards (``parallel.sharding.shard_state_dict``)."""
    if mesh is None:
        return net
    from multihmr_tpu_torch.parallel.sharding import shard_state_dict

    with torch.device("meta"):
        sharded = net_cls(cfg, tp_mode=tp_mode, mesh=mesh)
    sharded.load_state_dict(shard_state_dict(net.state_dict(), mesh, tp_mode), strict=True,
                            assign=True)
    return sharded


def build_model(name: str = "multiHMR_896_L", device="cuda", seed: int = 0,
                cfg=None, tp_mode: str = "heads", checkpoint=None, mesh=None):
    """MultiHMR (MultiHMRAnny for an Anny-family name) on ``device``, with the
    weights of a reference ``checkpoint`` (path or loaded dict) or else
    seeded random ones. ``cfg`` overrides the named configuration;
    ``tp_mode`` "ring" runs the ViT's standard stream (K5), "heads" the
    channels-major one (K1, K2). ``mesh``: this rank's shards of the same
    weights, the ViT sharded over the mesh's ``model`` axis."""
    from multihmr_tpu_torch.io import checkpoint as ckpt

    device = torch.device(device)
    if "anny" in name:
        cfg = cfg if cfg is not None else anny_config(name)
        state = None if checkpoint is None else ckpt.convert_reference_checkpoint_anny(
            checkpoint, cfg)
        net = _on_mesh(MultiHMRAnnyNet, cfg, tp_mode,
                       _net(MultiHMRAnnyNet, cfg, tp_mode, seed, state), mesh)
        return MultiHMRAnny(cfg, load_anny_model(device), net=net.to(device).eval(),
                            tp_mode=tp_mode, mesh=mesh)
    if cfg is None:
        cfg = smplx_config(name)
    state = None if checkpoint is None else ckpt.convert_reference_checkpoint(checkpoint, cfg)
    net = _on_mesh(MultiHMRNet, cfg, tp_mode, _net(MultiHMRNet, cfg, tp_mode, seed, state), mesh)
    bm = load_body_model(device, cfg.num_betas)
    return MultiHMR(cfg, bm, net=net.to(device).eval(), tp_mode=tp_mode, mesh=mesh)


def build_host_model(name: str) -> MultiHMR:
    """The ``MultiHMR`` that serves an exported artifact (``io/export.py``,
    ``cli/serve.py --artifact``): the configuration and the body model on
    the host, for reading the persons back and for the overlay's faces, and
    a net on the meta device, which holds no weights: the artifact carries
    them, so the card holds them once."""
    cfg = smplx_config(name)
    with torch.device("meta"):
        net = MultiHMRNet(cfg)
    return MultiHMR(cfg, load_body_model("cpu", cfg.num_betas), net=net)
