"""Checkpoints (``multihmr_tpu/io/checkpoint.py``): the port's own training
checkpoints, and the reference's released ``multiHMR_*.pt``.

The port's own format, in place of the JAX package's flax msgpack (params)
and orbax (full train state):

  * ``ckpt_{epoch:06d}.pt``: ``torch.save`` of the network's state dict, with
    ``ckpt_{epoch:06d}.json`` beside it holding the epoch and the config;
  * ``state/state_{epoch:06d}.pt``: the full train state (model and
    optimizer state dicts, epoch), which ``Trainer.restore`` resumes from
    bitwise.

The reference checkpoint is its own config system: ``ckpt['args']`` maps to
a :class:`ModelConfig` (:func:`config_from_ckpt_args`), and
:func:`convert_reference_checkpoint` maps its ``model_state_dict`` (hub
DINOv2 backbone and heads in one file) onto the port's state dict. It builds
the parameter tree the JAX package's ``convert_torch_checkpoint`` builds,
leaf for leaf, and ``io/convert.py::params_from_jax`` takes that tree to
the port's keys, so the reference → port mapping has one definition.
:func:`convert_reference_checkpoint_anny` does the same for the Anny family
(``multiHMR_*_anny.pt``) through ``params_from_jax_anny``.

The JAX package's own training checkpoints, ``ckpt_{epoch:06d}.msgpack``
(flax ``to_bytes`` of its parameter tree) with the same ``.json`` beside
them, load through :func:`load_jax_checkpoint`: ``io/flax_msgpack.py``
decodes the tree without flax, and ``params_from_jax`` maps it, strictly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import warnings
from typing import Any, Mapping

import numpy as np
import torch

from multihmr_tpu_torch.config import ModelConfig
from multihmr_tpu_torch.io.convert import params_from_jax, params_from_jax_anny
from multihmr_tpu_torch.ops.posenc import interpolate_dinov2_pos_embed
from multihmr_tpu_torch.port_config import BACKBONES as PORT_BACKBONES
from multihmr_tpu_torch.port_config import ffn_hidden, ffn_kind

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


def load_jax_checkpoint(path: str, cfg: ModelConfig):
    """(state dict, metadata dict or None) of the JAX package's
    ``save_checkpoint`` file (``ckpt_*.msgpack``; the metadata is the
    ``.json`` beside it), for ``cfg``. The load is strict: a parameter the
    port lacks, one it does not get, or a shape that differs raises."""
    from multihmr_tpu_torch.io.flax_msgpack import load as load_msgpack

    def fp32(tree):  # numpy has no bf16: a bf16 leaf arrives as a torch tensor
        if isinstance(tree, dict):
            return {k: fp32(v) for k, v in tree.items()}
        return tree.float().numpy() if isinstance(tree, torch.Tensor) else tree

    tree = load_msgpack(path)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: a flax checkpoint holds a parameter dict, not "
                         f"{type(tree).__name__}")
    state_dict = params_from_jax(fp32(tree), cfg)
    meta_path = re.sub(r"\.msgpack$", ".json", path)
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


# ---- the reference's released checkpoints ----


def config_from_ckpt_args(args: Mapping[str, Any], max_people: int = 16) -> ModelConfig:
    """Map a reference ``ckpt['args']`` namespace or dict onto ModelConfig."""
    get = lambda k, d: args.get(k, d) if isinstance(args, dict) else getattr(args, k, d)  # noqa: E731
    img_size = get("img_size", 896)
    if isinstance(img_size, (list, tuple)):  # stored as a list (reference demo.py:99)
        img_size = img_size[0]
    backbone = get("backbone", "dinov2_vitb14")
    return ModelConfig(
        backbone=backbone,
        vit_override=PORT_BACKBONES.get(backbone),
        img_size=int(img_size),
        camera_embedding_num_bands=int(get("camera_embedding_num_bands", 16)),
        camera_embedding_max_resolution=int(get("camera_embedding_max_resolution", 64)),
        nearness=bool(get("nearness", True)),
        clip_dist=bool(get("clip_dist", True)),
        xat_depth=int(get("xat_depth", 2)),
        xat_num_heads=int(get("xat_num_heads", 8)),
        person_center=get("person_center", "head"),
        num_betas=int(get("num_betas", 10)),
        max_people=max_people,
    )


def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear weight [out, in] → the JAX tree's kernel [in, out], as a
    view: ``params_from_jax`` transposes it back."""
    return w.T


def ffn_shapes(vit) -> dict:
    """The hub names and torch-side shapes of a ViT block's FFN: the GELU
    MLP's ``mlp.fc1``/``mlp.fc2``, or DINOv2's fused SwiGLU ``mlp.w12``
    (both halves, ``[2 hidden, D]``) and ``mlp.w3``."""
    D, H = vit.embed_dim, ffn_hidden(vit)
    if ffn_kind(vit) == "swiglufused":
        return {"mlp.w12.weight": (2 * H, D), "mlp.w12.bias": (2 * H,),
                "mlp.w3.weight": (D, H), "mlp.w3.bias": (D,)}
    return {"mlp.fc1.weight": (H, D), "mlp.fc1.bias": (H,),
            "mlp.fc2.weight": (D, H), "mlp.fc2.bias": (D,)}


def expected_reference_keys(cfg: ModelConfig) -> set:
    """Every state-dict key :func:`convert_reference_checkpoint` consumes for
    a config: the contract with the reference's naming (hub-DINOv2 backbone
    and model.py heads), so that all missing keys are reported at once."""
    keys = set()
    bb = "backbone.encoder."
    keys |= {
        bb + "patch_embed.proj.weight", bb + "patch_embed.proj.bias",
        bb + "cls_token", bb + "pos_embed", bb + "norm.weight", bb + "norm.bias",
    }
    for i in range(cfg.vit.depth):
        b = f"{bb}blocks.{i}."
        keys |= {
            b + "norm1.weight", b + "norm1.bias",
            b + "attn.qkv.weight", b + "attn.qkv.bias",
            b + "attn.proj.weight", b + "attn.proj.bias",
            b + "ls1.gamma", b + "ls2.gamma",
            b + "norm2.weight", b + "norm2.bias",
        }
        keys |= {b + k for k in ffn_shapes(cfg.vit)}
    for m in ("mlp_classif", "mlp_offset"):
        keys |= {f"{m}.0.weight", f"{m}.0.bias", f"{m}.2.weight", f"{m}.2.bias"}
    xa = "x_attention_head."
    keys |= {
        xa + "cross_queries_x", xa + "cross_queries_y",
        xa + "cross_values_x", xa + "cross_values_y",
        xa + "init_body_pose", xa + "init_betas", xa + "init_cam",
        xa + "init_expression",
        xa + "transformer.to_token_embedding.weight",
        xa + "transformer.to_token_embedding.bias",
        xa + "transformer.pos_embedding",
    }
    for d in ("decpose", "decshape", "deccam", "decexpression"):
        keys |= {xa + d + ".weight", xa + d + ".bias"}
    for i in range(cfg.xat_depth):
        layer = f"{xa}transformer.transformer.layers.{i}."
        keys |= {
            layer + "0.norm.weight", layer + "0.norm.bias",
            layer + "0.fn.to_qkv.weight",
            layer + "0.fn.to_out.0.weight", layer + "0.fn.to_out.0.bias",
            layer + "1.norm.weight", layer + "1.norm.bias",
            layer + "1.fn.to_kv.weight", layer + "1.fn.to_q.weight",
            layer + "1.fn.to_out.0.weight", layer + "1.fn.to_out.0.bias",
            layer + "2.norm.weight", layer + "2.norm.bias",
            layer + "2.fn.net.0.weight", layer + "2.fn.net.0.bias",
            layer + "2.fn.net.3.weight", layer + "2.fn.net.3.bias",
        }
    return keys


def expected_reference_shapes(cfg: ModelConfig) -> dict:
    """The torch-side shape of every key :func:`convert_reference_checkpoint`
    consumes (``None`` = any size): a layout mismatch in a real file would
    otherwise pass the reshapes and give wrong weights."""
    vit = cfg.vit
    D = vit.embed_dim
    hph = cfg.hph
    inner = hph.heads * hph.dim_head
    C = D + cfg.camera_embed_dim
    shapes = {}
    bb = "backbone.encoder."
    shapes[bb + "patch_embed.proj.weight"] = (D, 3, 14, 14)
    shapes[bb + "patch_embed.proj.bias"] = (D,)
    shapes[bb + "cls_token"] = (1, 1, D)
    # (1, 1 + g0², D) for any source grid g0: resampled to the working grid
    shapes[bb + "pos_embed"] = (1, None, D)
    shapes[bb + "norm.weight"] = (D,)
    shapes[bb + "norm.bias"] = (D,)
    for i in range(vit.depth):
        b = f"{bb}blocks.{i}."
        for nrm in ("norm1", "norm2"):
            shapes[b + nrm + ".weight"] = (D,)
            shapes[b + nrm + ".bias"] = (D,)
        shapes[b + "attn.qkv.weight"] = (3 * D, D)
        shapes[b + "attn.qkv.bias"] = (3 * D,)
        shapes[b + "attn.proj.weight"] = (D, D)
        shapes[b + "attn.proj.bias"] = (D,)
        shapes[b + "ls1.gamma"] = (D,)
        shapes[b + "ls2.gamma"] = (D,)
        shapes.update({b + k: v for k, v in ffn_shapes(vit).items()})
    for m, od in (("mlp_classif", 1), ("mlp_offset", 2)):
        shapes[f"{m}.0.weight"] = (D, D)
        shapes[f"{m}.0.bias"] = (D,)
        shapes[f"{m}.2.weight"] = (od, D)
        shapes[f"{m}.2.bias"] = (od,)
    xa = "x_attention_head."
    g = cfg.grid_size
    for name in ("cross_queries_x", "cross_queries_y",
                 "cross_values_x", "cross_values_y"):
        shapes[xa + name] = (g, C)
    shapes[xa + "init_body_pose"] = (1, cfg.npose)
    shapes[xa + "init_betas"] = (1, cfg.num_betas)
    shapes[xa + "init_cam"] = (1, 3)
    shapes[xa + "init_expression"] = (1, 10)
    shapes[xa + "transformer.to_token_embedding.weight"] = (hph.dim, cfg.token_dim)
    shapes[xa + "transformer.to_token_embedding.bias"] = (hph.dim,)
    shapes[xa + "transformer.pos_embedding"] = (1, None, hph.dim)
    for dec, od in (("decpose", cfg.npose), ("decshape", cfg.num_betas),
                    ("deccam", 3), ("decexpression", 10)):
        shapes[xa + dec + ".weight"] = (od, hph.dim)
        shapes[xa + dec + ".bias"] = (od,)
    for i in range(cfg.xat_depth):
        layer = f"{xa}transformer.transformer.layers.{i}."
        for j in (0, 1, 2):
            shapes[layer + f"{j}.norm.weight"] = (hph.dim,)
            shapes[layer + f"{j}.norm.bias"] = (hph.dim,)
        shapes[layer + "0.fn.to_qkv.weight"] = (3 * inner, hph.dim)
        shapes[layer + "0.fn.to_out.0.weight"] = (hph.dim, inner)
        shapes[layer + "0.fn.to_out.0.bias"] = (hph.dim,)
        shapes[layer + "1.fn.to_kv.weight"] = (2 * inner, C)
        shapes[layer + "1.fn.to_q.weight"] = (inner, hph.dim)
        shapes[layer + "1.fn.to_out.0.weight"] = (hph.dim, inner)
        shapes[layer + "1.fn.to_out.0.bias"] = (hph.dim,)
        shapes[layer + "2.fn.net.0.weight"] = (hph.mlp_dim, hph.dim)
        shapes[layer + "2.fn.net.0.bias"] = (hph.mlp_dim,)
        shapes[layer + "2.fn.net.3.weight"] = (hph.dim, hph.mlp_dim)
        shapes[layer + "2.fn.net.3.bias"] = (hph.dim,)
    return shapes


def expected_reference_keys_anny(cfg) -> set:
    """Every key :func:`convert_reference_checkpoint_anny` consumes (reference
    multi_hmr_anny/multi_hmr.py naming), also for ``bodymodel/manifest.py``'s
    check of ``multiHMR_*_anny`` files."""
    keys = {"dec_to_token.weight", "dec_to_token.bias", "dec_pos_emb", "init_body_pose"}
    bb = "encoder.backbone."
    keys |= {
        bb + "patch_embed.proj.weight", bb + "patch_embed.proj.bias",
        bb + "cls_token", bb + "pos_embed", bb + "norm.weight", bb + "norm.bias",
    }
    for i in range(cfg.vit.depth):
        b = f"{bb}blocks.{i}."
        keys |= {
            b + "norm1.weight", b + "norm1.bias",
            b + "attn.qkv.weight", b + "attn.qkv.bias",
            b + "attn.proj.weight", b + "attn.proj.bias",
            b + "ls1.gamma", b + "ls2.gamma",
            b + "norm2.weight", b + "norm2.bias",
            b + "mlp.fc1.weight", b + "mlp.fc1.bias",
            b + "mlp.fc2.weight", b + "mlp.fc2.bias",
        }
    for m in ("encoder.mlp_det", "encoder.mlp_fov_unique",
              "mlp_offset", "mlp_pose", "mlp_shape", "mlp_dist"):
        keys |= {f"{m}.0.weight", f"{m}.0.bias", f"{m}.2.weight", f"{m}.2.bias"}
    for i in range(cfg.xat_depth):
        layer = f"decoder.transformer.layers.{i}."
        keys |= {
            layer + "0.norm.weight", layer + "0.norm.bias",
            layer + "0.fn.to_qkv.weight",
            layer + "0.fn.to_out.0.weight", layer + "0.fn.to_out.0.bias",
            layer + "1.norm.weight", layer + "1.norm.bias",
            layer + "1.fn.to_kv.weight", layer + "1.fn.to_q.weight",
            layer + "1.fn.to_out.0.weight", layer + "1.fn.to_out.0.bias",
            layer + "2.norm.weight", layer + "2.norm.bias",
            layer + "2.fn.net.0.weight", layer + "2.fn.net.0.bias",
            layer + "2.fn.net.3.weight", layer + "2.fn.net.3.bias",
        }
    return keys


# Keys a reference checkpoint may carry that the model has no use for
# (buffers, the stripped smpl layer): ignored, never warned about.
_IGNORABLE = re.compile(r"^smpl_layer|init_betas_kid$|^backbone\.encoder\.mask_token$")


def validate_reference_state_dict(sd: Mapping[str, Any], cfg: ModelConfig) -> dict:
    """{'missing': sorted list, 'unexpected': sorted list, 'ignored': list,
    'bad_shape': ["key: got (..), expected (..)"]}. ``bad_shape`` checks
    every present consumed key against :func:`expected_reference_shapes`
    (None dims are wildcards)."""
    expected = expected_reference_keys(cfg)
    present = set(sd.keys())
    ignored = sorted(k for k in present - expected if _IGNORABLE.search(k))
    shapes = expected_reference_shapes(cfg)
    bad_shape = []
    for k in sorted(expected & present):
        want = shapes.get(k)
        if want is None:
            continue
        got = tuple(getattr(sd[k], "shape", np.asarray(sd[k]).shape))
        if len(got) != len(want) or any(
            w is not None and int(g) != w for g, w in zip(got, want)
        ):
            bad_shape.append(f"{k}: got {tuple(int(x) for x in got)}, expected {want}")
    return {
        "missing": sorted(expected - present),
        "unexpected": sorted(k for k in present - expected if not _IGNORABLE.search(k)),
        "ignored": ignored,
        "bad_shape": bad_shape,
    }


def _fp32(v) -> np.ndarray:
    """A state-dict value as fp32 numpy, whatever dtype the file stores
    (numpy has no bf16, so torch tensors are cast before the handover)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def convert_reference_checkpoint(ckpt_or_path, cfg: ModelConfig) -> dict:
    """A reference checkpoint (path, ``{'model_state_dict', 'args'}`` or a
    bare state dict) → the port's ``MultiHMRNet`` state dict (fp32 CPU
    tensors) for ``cfg``: :func:`jax_tree_from_reference`, then
    ``params_from_jax``."""
    return params_from_jax(jax_tree_from_reference(ckpt_or_path, cfg), cfg)


def jax_tree_from_reference(ckpt_or_path, cfg: ModelConfig) -> dict:
    """A reference checkpoint → the JAX package's ``{"params": tree}`` for
    ``cfg`` (fp32 numpy leaves, some of them transposed views), leaf for leaf
    what its ``convert_torch_checkpoint`` builds.

    Missing keys raise a ``KeyError`` that lists them all, tensors of the
    wrong shape a ``ValueError``; keys the converter does not use warn
    (the reference loads with ``strict=False``, demo.py:103)."""
    if isinstance(ckpt_or_path, (str, os.PathLike)):
        # weights_only=False: ckpt["args"] is an argparse namespace
        ckpt = torch.load(ckpt_or_path, map_location="cpu", weights_only=False)
    else:
        ckpt = ckpt_or_path
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {k: _fp32(v) for k, v in sd.items()
          if not k.startswith("smpl_layer")}  # stripped at save anyway (train.py:197-201)

    report = validate_reference_state_dict(sd, cfg)
    if report["missing"]:
        raise KeyError(
            f"checkpoint is missing {len(report['missing'])} expected keys for "
            f"config (backbone={cfg.backbone}, img={cfg.img_size}, "
            f"betas={cfg.num_betas}, xat_depth={cfg.xat_depth}):\n  "
            + "\n  ".join(report["missing"][:40])
            + ("\n  ..." if len(report["missing"]) > 40 else "")
            + "\nLikely a config/checkpoint mismatch — rebuild the config via "
            "config_from_ckpt_args(ckpt['args'])."
        )
    if report["bad_shape"]:
        raise ValueError(
            f"{len(report['bad_shape'])} checkpoint tensors have shapes the "
            f"converter's transposes/reshapes cannot accept (layout or "
            f"config mismatch):\n  " + "\n  ".join(report["bad_shape"][:20])
            + ("\n  ..." if len(report["bad_shape"]) > 20 else "")
        )
    if report["unexpected"]:
        warnings.warn(
            f"{len(report['unexpected'])} unexpected checkpoint keys ignored "
            f"(strict=False, reference demo.py:103): "
            + ", ".join(report["unexpected"][:10])
            + ("..." if len(report["unexpected"]) > 10 else ""),
            stacklevel=2,
        )

    vit = cfg.vit
    g = cfg.grid_size
    p = {}

    # ---- backbone (hub DINOv2 naming) ----
    bb = "backbone.encoder."
    pe_w = sd[bb + "patch_embed.proj.weight"]  # [D, 3, 14, 14] → (row, col, channel) rows
    patch_kernel = pe_w.transpose(2, 3, 1, 0).reshape(-1, vit.embed_dim)
    backbone = {
        "patch_embed": {"kernel": patch_kernel, "bias": sd[bb + "patch_embed.proj.bias"]},
        "cls_token": sd[bb + "cls_token"].reshape(1, 1, vit.embed_dim),
        "pos_embed": interpolate_dinov2_pos_embed(sd[bb + "pos_embed"], g),
        "norm": {"scale": sd[bb + "norm.weight"], "bias": sd[bb + "norm.bias"]},
    }

    def stacked(fmt, transpose=False):  # the JAX tree's scanned blocks: depth first
        arrs = [sd[f"{bb}blocks.{i}.{fmt}"] for i in range(vit.depth)]
        if transpose:
            arrs = [_t(a) for a in arrs]
        return np.stack(arrs, axis=0)

    backbone["blocks"] = {
        "block": {
            "norm1": {"scale": stacked("norm1.weight"), "bias": stacked("norm1.bias")},
            "attn": {
                "qkv": {"kernel": stacked("attn.qkv.weight", True),
                        "bias": stacked("attn.qkv.bias")},
                "proj": {"kernel": stacked("attn.proj.weight", True),
                         "bias": stacked("attn.proj.bias")},
            },
            "ls1": {"gamma": stacked("ls1.gamma")},
            "norm2": {"scale": stacked("norm2.weight"), "bias": stacked("norm2.bias")},
            # fc1/fc2, or the SwiGLU's w12/w3 (no JAX counterpart: the port's names)
            "mlp": {name: {"kernel": stacked(f"mlp.{name}.weight", True),
                           "bias": stacked(f"mlp.{name}.bias")}
                    for name in dict.fromkeys(k.split(".")[1] for k in ffn_shapes(vit))},
            "ls2": {"gamma": stacked("ls2.gamma")},
        }
    }
    p["backbone"] = backbone

    # ---- detection / offset MLPs (Sequential Linear-ReLU-Linear) ----
    for m in ("mlp_classif", "mlp_offset"):
        p[m] = {
            "fc0": {"kernel": _t(sd[f"{m}.0.weight"]), "bias": sd[f"{m}.0.bias"]},
            "fc1": {"kernel": _t(sd[f"{m}.2.weight"]), "bias": sd[f"{m}.2.bias"]},
        }

    # ---- HPH head ----
    xa = "x_attention_head."
    dense = lambda name: {"kernel": _t(sd[name + ".weight"]), "bias": sd[name + ".bias"]}  # noqa: E731
    norm = lambda name: {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}  # noqa: E731
    head = {name: sd[xa + name] for name in (
        "cross_queries_x", "cross_queries_y", "cross_values_x", "cross_values_y",
        "init_body_pose", "init_betas", "init_cam", "init_expression")}
    head["to_token_embedding"] = dense(xa + "transformer.to_token_embedding")
    head["pos_embedding"] = sd[xa + "transformer.pos_embedding"]
    for dec in ("decpose", "decshape", "deccam", "decexpression"):
        head[dec] = dense(xa + dec)
    for i in range(cfg.xat_depth):
        layer = f"{xa}transformer.transformer.layers.{i}."
        head[f"sa_norm{i}"] = norm(layer + "0.norm")
        head[f"sa{i}"] = {"to_qkv": {"kernel": _t(sd[layer + "0.fn.to_qkv.weight"])},
                          "to_out": dense(layer + "0.fn.to_out.0")}
        head[f"ca_norm{i}"] = norm(layer + "1.norm")
        head[f"ca{i}"] = {"to_kv": {"kernel": _t(sd[layer + "1.fn.to_kv.weight"])},
                          "to_q": {"kernel": _t(sd[layer + "1.fn.to_q.weight"])},
                          "to_out": dense(layer + "1.fn.to_out.0")}
        head[f"ff_norm{i}"] = norm(layer + "2.norm")
        head[f"ff{i}"] = {"fc1": dense(layer + "2.fn.net.0"), "fc2": dense(layer + "2.fn.net.3")}
    p["x_attention_head"] = head
    return {"params": p}


class _HintingSD(dict):
    """dict whose KeyError names the missing checkpoint key and lists the
    same-prefix keys that do exist (the JAX package's words)."""

    def __missing__(self, k):
        prefix = k.split(".")[0]
        near = sorted(x for x in self if x.startswith(prefix))[:8]
        raise KeyError(
            f"checkpoint key {k!r} not found; available keys with prefix "
            f"{prefix!r}: {near if near else sorted(self)[:8]}"
        )


def convert_reference_checkpoint_anny(ckpt_or_path, cfg) -> dict:
    """A reference Anny checkpoint (path, ``{'model_state_dict', ...}`` or a
    bare state dict) → the port's ``MultiHMRAnnyNet`` state dict (fp32 CPU
    tensors) for the :class:`AnnyConfig` ``cfg``.

    As the JAX package's ``convert_torch_checkpoint_anny``: ``body_model*``
    keys are dropped, other keys it does not use (``useful_rotmat``) are
    ignored, and the first missing key raises a ``KeyError`` that names it
    and its same-prefix neighbours."""
    if isinstance(ckpt_or_path, (str, os.PathLike)):
        ckpt = torch.load(ckpt_or_path, map_location="cpu", weights_only=False)
    else:
        ckpt = ckpt_or_path
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = _HintingSD({k: _fp32(v) for k, v in sd.items() if not k.startswith("body_model")})
    vit = cfg.vit
    g = cfg.grid_size
    bb = "encoder.backbone."
    pe_w = sd[bb + "patch_embed.proj.weight"]

    def stacked(fmt, transpose=False):  # the JAX tree's scanned blocks: depth first
        arrs = [sd[f"{bb}blocks.{i}.{fmt}"] for i in range(vit.depth)]
        if transpose:
            arrs = [_t(a) for a in arrs]
        return np.stack(arrs, axis=0)

    def seq_mlp(prefix):  # Sequential Linear-ReLU-Linear
        return {"fc0": {"kernel": _t(sd[f"{prefix}.0.weight"]), "bias": sd[f"{prefix}.0.bias"]},
                "fc1": {"kernel": _t(sd[f"{prefix}.2.weight"]), "bias": sd[f"{prefix}.2.bias"]}}

    def dense(name):
        return {"kernel": _t(sd[name + ".weight"]), "bias": sd[name + ".bias"]}

    encoder = {
        "backbone": {
            "patch_embed": {"kernel": pe_w.transpose(2, 3, 1, 0).reshape(-1, vit.embed_dim),
                            "bias": sd[bb + "patch_embed.proj.bias"]},
            "cls_token": sd[bb + "cls_token"].reshape(1, 1, vit.embed_dim),
            "pos_embed": interpolate_dinov2_pos_embed(sd[bb + "pos_embed"], g),
            "norm": {"scale": sd[bb + "norm.weight"], "bias": sd[bb + "norm.bias"]},
            "blocks": {"block": {
                "norm1": {"scale": stacked("norm1.weight"), "bias": stacked("norm1.bias")},
                "attn": {
                    "qkv": {"kernel": stacked("attn.qkv.weight", True),
                            "bias": stacked("attn.qkv.bias")},
                    "proj": {"kernel": stacked("attn.proj.weight", True),
                             "bias": stacked("attn.proj.bias")},
                },
                "ls1": {"gamma": stacked("ls1.gamma")},
                "norm2": {"scale": stacked("norm2.weight"), "bias": stacked("norm2.bias")},
                "mlp": {
                    "fc1": {"kernel": stacked("mlp.fc1.weight", True),
                            "bias": stacked("mlp.fc1.bias")},
                    "fc2": {"kernel": stacked("mlp.fc2.weight", True),
                            "bias": stacked("mlp.fc2.bias")},
                },
                "ls2": {"gamma": stacked("ls2.gamma")},
            }},
        },
        "mlp_det": seq_mlp("encoder.mlp_det"),
        "mlp_fov_unique": seq_mlp("encoder.mlp_fov_unique"),
    }
    decoder = {}
    for i in range(cfg.xat_depth):
        layer = f"decoder.transformer.layers.{i}."
        for j, tag in [(0, "sa"), (1, "ca"), (2, "ff")]:
            decoder[f"{tag}_norm{i}"] = {"scale": sd[layer + f"{j}.norm.weight"],
                                         "bias": sd[layer + f"{j}.norm.bias"]}
        decoder[f"sa{i}"] = {"to_qkv": {"kernel": _t(sd[layer + "0.fn.to_qkv.weight"])},
                             "to_out": dense(layer + "0.fn.to_out.0")}
        decoder[f"ca{i}"] = {"to_kv": {"kernel": _t(sd[layer + "1.fn.to_kv.weight"])},
                             "to_q": {"kernel": _t(sd[layer + "1.fn.to_q.weight"])},
                             "to_out": dense(layer + "1.fn.to_out.0")}
        decoder[f"ff{i}"] = {"fc1": dense(layer + "2.fn.net.0"), "fc2": dense(layer + "2.fn.net.3")}
    params = {
        "encoder": encoder,
        "dec_to_token": dense("dec_to_token"),
        "decoder": decoder,
        "mlp_offset": seq_mlp("mlp_offset"),
        "mlp_pose": seq_mlp("mlp_pose"),
        "mlp_shape": seq_mlp("mlp_shape"),
        "mlp_dist": seq_mlp("mlp_dist"),
    }
    constants = {"dec_pos_emb": sd["dec_pos_emb"].reshape(g, g, -1),
                 "init_body_pose": sd["init_body_pose"]}
    return params_from_jax_anny({"params": params, "constants": constants}, cfg)
