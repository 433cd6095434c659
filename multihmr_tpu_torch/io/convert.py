"""Carry weights across from the JAX package.

:func:`params_from_jax` maps the JAX package's ``{"params": ...}`` tree (as
numpy arrays; no jax is imported here) onto the port's ``state_dict``:

  * the scanned ViT blocks (``backbone/blocks/block/...``, each leaf with a
    leading depth axis) are unstacked into ``backbone.blocks.{i}....``;
  * Dense ``kernel [in, out]`` becomes ``nn.Linear`` ``weight [out, in]``;
    the patch-embed kernel keeps its (row, col, channel) unfold order, so the
    port's unfold feeds it unchanged;
  * LayerNorm ``scale`` becomes ``weight``; every other leaf keeps its name.

Every JAX leaf must land on a port key and every port key must be filled,
with the port's shape: anything else raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from multihmr_tpu_torch.config import ModelConfig

_STACKED = ("backbone", "blocks", "block")


def _flatten(tree: Mapping, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _leaf(path: tuple, arr: np.ndarray):
    """(port module path + leaf name, array) for one JAX leaf."""
    *mods, name = path
    if name == "kernel":
        return mods + ["weight"], np.swapaxes(arr, -1, -2)
    if name == "scale":
        return mods + ["weight"], arr
    return mods + [name], arr


def rename_tree(tree: Mapping, depth: int) -> dict:
    """JAX parameter tree → {port key: numpy array}, unvalidated."""
    sd = {}
    for path, arr in _flatten(tree).items():
        if path[:3] == _STACKED:
            mods, arr = _leaf(path[3:], arr)
            if arr.shape[0] != depth:
                raise ValueError(f"{'/'.join(path)}: leading axis {arr.shape[0]} "
                                 f"is not the depth {depth}")
            items = [(".".join(["backbone", "blocks", str(i)] + mods), arr[i])
                     for i in range(depth)]
        else:
            mods, arr = _leaf(path, arr)
            items = [(".".join(mods), arr)]
        for key, a in items:
            if key in sd:
                raise KeyError(f"two JAX leaves map to the port key {key}")
            sd[key] = a
    return sd


def params_from_jax(params: Mapping, cfg: ModelConfig) -> dict:
    """JAX ``{"params": tree}`` (numpy leaves) → port ``state_dict`` (fp32)."""
    from multihmr_tpu_torch.models.multihmr import MultiHMRNet

    sd = rename_tree(params["params"] if "params" in params else params, cfg.vit.depth)
    with torch.device("meta"):
        want = MultiHMRNet(cfg).state_dict()
    unused = sorted(set(sd) - set(want))
    missing = sorted(set(want) - set(sd))
    if unused or missing:
        raise KeyError(f"JAX leaves with no port key: {unused[:10]}; "
                       f"port keys not filled: {missing[:10]}")
    out = {}
    for k, t in want.items():
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(f"{k}: JAX gives {sd[k].shape}, port wants {tuple(t.shape)}")
        out[k] = torch.from_numpy(np.array(sd[k], dtype=np.float32))
    return out
