"""Training checkpoints: save, load, prune (``multihmr_tpu/io/checkpoint.py``).

The port's own format, in place of the JAX package's flax msgpack (params)
and orbax (full train state):

  * ``ckpt_{epoch:06d}.pt``: ``torch.save`` of the network's state dict, with
    ``ckpt_{epoch:06d}.json`` beside it holding the epoch and the config;
  * ``state/state_{epoch:06d}.pt``: the full train state (model and
    optimizer state dicts, epoch), which ``Trainer.restore`` resumes from
    bitwise.

Loading the reference ``multiHMR_*.pt`` checkpoints is not here yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import torch

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")
_STATE = re.compile(r"state_(\d+)\.pt$")


def _host(state_dict: dict) -> dict:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def save_checkpoint(ckpt_dir: str, state_dict: dict, epoch: int, cfg) -> str:
    """Network weights + a JSON of the epoch and config; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{epoch:06d}.pt")
    torch.save(_host(state_dict), path)
    with open(os.path.join(ckpt_dir, f"ckpt_{epoch:06d}.json"), "w") as f:
        json.dump({"epoch": epoch, "config": dataclasses.asdict(cfg)}, f)
    return path


def load_checkpoint(path: str, map_location="cpu"):
    """(state dict, metadata dict or None) of a :func:`save_checkpoint` file."""
    state_dict = torch.load(path, map_location=map_location, weights_only=True)
    meta_path = re.sub(r"\.pt$", ".json", path)
    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state_dict, meta


def _prune(ckpt_dir: str, pattern, keep: int, exts=(".pt",)):
    found = sorted(f for f in os.listdir(ckpt_dir) if pattern.match(f))
    for old in found[:-keep] if keep > 0 else []:
        for ext in exts:
            path = os.path.join(ckpt_dir, old.replace(".pt", ext))
            if os.path.exists(path):
                os.remove(path)


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Retain the last ``keep`` weight checkpoints."""
    _prune(ckpt_dir, _CKPT, keep, exts=(".pt", ".json"))


def save_train_state(ckpt_dir: str, epoch: int, model_state: dict, optimizer_state: dict,
                     keep: int) -> str:
    """Full train state under ``ckpt_dir/state``, the last ``keep`` kept."""
    d = os.path.join(ckpt_dir, "state")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"state_{epoch:06d}.pt")
    tmp = path + ".tmp"
    torch.save({"epoch": epoch, "model": _host(model_state),
                "optimizer": optimizer_state}, tmp)
    os.replace(tmp, path)  # a killed run never leaves half a state
    _prune(d, _STATE, keep)
    return path


def latest_train_state(ckpt_dir: str):
    """The newest full train state (``{"epoch", "model", "optimizer"}``),
    or None when there is none."""
    d = os.path.join(ckpt_dir, "state")
    found = sorted(f for f in os.listdir(d) if _STATE.match(f)) if os.path.isdir(d) else []
    if not found:
        return None
    return torch.load(os.path.join(d, found[-1]), map_location="cpu", weights_only=True)
