"""The rank side of tests/test_torch_parallel.py, test_torch_ring_attention.py
and test_torch_cli_train.py's mesh case: functions that spawned gloo ranks
run (``multihmr_tpu_torch.parallel.launch``). It imports no jax: each rank
imports this module anew. Inputs come from a file the test writes; every
function returns numpy arrays and plain values for the test to compare."""

from __future__ import annotations

import os

import torch

LR = 1e-3
CLIP = 1.0  # well below the tiny model's gradient norm: every step clips
BM_ARGS = dict(num_vertices=64, num_joints=55, num_extra=21, num_lmk=51)


def _np(t):
    return t.detach().cpu().double().numpy()


def digest(tensors: dict) -> dict:
    """name → sha1 of the tensor's bytes (a bitwise comparison that ships
    20 bytes a tensor)."""
    import hashlib

    return {k: hashlib.sha1(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


def grad_errors(grads: dict, ref: dict) -> dict:
    """name → max |g - ref| / max |ref| of full gradients."""
    return {n: float((g - ref[n]).abs().max() / ref[n].abs().max().clamp(min=1e-30))
            for n, g in grads.items()}


def port_cfg():
    """The tests' tiny configuration (tests/test_checkpoint.py's TinyConfig
    at 56 px) in the port's own config, LayerScale 0.5 so that the blocks
    move the stream."""
    from multihmr_tpu_torch.config import ModelConfig, ViTConfig

    return ModelConfig(img_size=56, max_people=4, person_center="head", compute_dtype="float32",
                       vit_override=ViTConfig(embed_dim=32, depth=2, num_heads=2,
                                              layerscale_init=0.5))


def port_model(state, mesh=None, tp_mode="heads"):
    """MultiHMR with ``state`` (full, single-device) or this rank's shards of it."""
    from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
    from multihmr_tpu_torch.bodymodel.core import BodyModel
    from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
    from multihmr_tpu_torch.parallel.sharding import shard_state_dict

    cfg = port_cfg()
    net = MultiHMRNet(cfg, tp_mode=tp_mode, mesh=mesh)
    net.load_state_dict(shard_state_dict(state, mesh, tp_mode) if mesh is not None else state)
    return MultiHMR(cfg, BodyModel.from_arrays(synthetic_body_model(**BM_ARGS), "cpu"), net=net,
                    tp_mode=tp_mode, mesh=mesh)


def make_trainer(state, mesh=None, fsdp=False, ckpt_dir=None, clip_grad=0.0):
    """The Trainer (Adam) of ``port_model(state, mesh)``, FSDP over 'data'
    for leaves of 64 elements and up with ``fsdp``."""
    from multihmr_tpu_torch.train.trainer import Trainer

    model = port_model(state, mesh)
    return Trainer(model, torch.optim.Adam(model.net.parameters(), lr=LR, eps=1e-8),
                   mesh=mesh, fsdp=fsdp, fsdp_min_size=64, checkpoint_dir=ckpt_dir,
                   clip_grad=clip_grad)


def train_once(state, batch, mesh=None, fsdp=False, clip_grad=0.0):
    """One Adam step of the Trainer on ``batch`` (global; a mesh rank takes
    its slice): (trainer, whole-batch loss terms, full gradients, clipped
    where ``clip_grad`` > 0)."""
    from multihmr_tpu_torch.parallel import sharding
    from multihmr_tpu_torch.train.trainer import BATCH_KEYS, to_device

    trainer = make_trainer(state, mesh, fsdp, clip_grad=clip_grad)
    model = trainer.model
    b = {k: batch[k] for k in BATCH_KEYS}
    if mesh is not None:
        b = sharding.shard_batch(b, mesh)
    terms = trainer.train_step(to_device(b, "cpu"), 0)
    grads = {n: (sharding.gather_tensor(n, p.grad, mesh, model.tp_mode) if mesh is not None
                 else p.grad.detach().clone()) for n, p in model.net.named_parameters()}
    return trainer, {k: float(v) for k, v in terms.items()}, grads


def _forward(state, x, K, mesh, tp_mode):
    from multihmr_tpu_torch.parallel.sharding import shard_batch

    b = shard_batch({"x": torch.from_numpy(x), "K": torch.from_numpy(K)}, mesh)
    with torch.no_grad():
        out = port_model(state, mesh, tp_mode).forward(b["x"], b["K"])
    return {k: _np(out[k]) for k in ("v3d", "scores")}


def parallel_world(rank, n, path):
    """tests/test_torch_parallel.py on a (2, 2) mesh of 4 ranks."""
    from torch.distributed.tensor import DTensor

    from multihmr_tpu_torch.io import checkpoint as ckpt
    from multihmr_tpu_torch.parallel import sharding

    inp = torch.load(path, weights_only=False)
    state, batch = inp["state"], inp["batch"]
    mesh = sharding.make_mesh(n, 2, device_type="cpu")
    flat = sharding.make_mesh(n, 1, device_type="cpu")
    out = {"coords": (mesh["data"].get_local_rank(), mesh["model"].get_local_rank()),
           "shapes": [dict(zip(m.mesh_dim_names, m.shape)) for m in (mesh, flat)],
           "world": (torch.distributed.get_world_size(), torch.distributed.get_backend())}
    for tp_mode in ("heads", "ring"):
        out[f"fwd_{tp_mode}"] = _forward(state, batch["image"], batch["K"], mesh, tp_mode)

    out["valid_here"] = float(sharding.shard_batch({"v": batch["gt_valid"]}, mesh)["v"].sum())
    _, out["tp_terms"], grads = train_once(state, batch, mesh)
    out["tp_grads"] = grad_errors(grads, inp["grads"])
    _, _, grads = train_once(state, batch, mesh, fsdp=True, clip_grad=CLIP)
    out["clip_grads"] = grad_errors(grads, inp["clip_grads"])
    trainer, out["fsdp_terms"], grads = train_once(state, batch, mesh, fsdp=True)
    out["fsdp_grads"] = grad_errors(grads, inp["grads"])

    # what FSDP sharded, and the Adam moments beside the parameters
    net = trainer.model.net
    out["dtensor_params"] = sorted(k for k, p in net.named_parameters() if isinstance(p, DTensor))
    out["small_params"] = sorted(k for k, p in net.named_parameters() if p.numel() < 64)
    qkv = "backbone.blocks.0.attn.qkv.weight"
    p = dict(net.named_parameters())[qkv]
    st = trainer.optimizer.state[p]
    out["moment"] = {"dtensor": isinstance(st["exp_avg"], DTensor),
                     "local": tuple(st["exp_avg"].to_local().shape), "full": tuple(p.shape),
                     "step_plain": not isinstance(st["step"], DTensor)}
    out["names"] = [n for n, _ in net.named_parameters()]
    out["moment_bytes"] = sum((v.to_local() if isinstance(v, DTensor) else v).numel()
                              * v.element_size()
                              for s in trainer.optimizer.state.values()
                              for k, v in s.items() if k.startswith("exp_avg"))

    # checkpoints: the mesh writes the full state in the single-device format
    full, opt = trainer.full_state(), trainer._optimizer_state()
    if rank == 0:
        ckpt.save_train_state(inp["mesh_ckpt"], 0, full, opt, 3)
    torch.distributed.barrier()
    out["mesh_state"] = digest(full)
    out["mesh_moments"] = digest({i: s["exp_avg_sq"] for i, s in opt["state"].items()})
    # ... and restores a single-device state into its shards
    back = make_trainer(state, mesh, fsdp=True, ckpt_dir=inp["single_ckpt"])
    back.restore()
    out["restored_state"] = digest(back.full_state())
    back_opt = back._optimizer_state()
    out["restored_moments"] = digest({i: s["exp_avg_sq"] for i, s in back_opt["state"].items()})
    out["restored_step"] = [float(s["step"]) for s in back_opt["state"].values()]
    return out


def ring_world(rank, n, path):
    """tests/test_torch_ring_attention.py on 4 ranks: model 4, and (2, 2)."""
    import importlib

    from multihmr_tpu_torch.parallel import sharding

    # the module (the package re-exports its function of the same name)
    ra = importlib.import_module("multihmr_tpu_torch.parallel.ring_attention")

    inp = torch.load(path, weights_only=False)
    ring = sharding.make_mesh(n, n, device_type="cpu")
    group = ring["model"].get_group()
    me = ring["model"].get_local_rank()
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    out = {}

    q, k, v = (t(a) for a in inp["ring64"])  # [1, 2, 64, 16], this rank's quarter
    s = q.shape[2] // n
    out["ring64"] = _np(ra.ring_attention(*(x[:, :, me * s:(me + 1) * s] for x in (q, k, v)),
                                          group))
    q, k, v = (t(a) for a in inp["ring32"])
    s = q.shape[2] // n
    out["ring32"] = _np(ra.ring_attention(*(x[:, :, me * s:(me + 1) * s] for x in (q, k, v)),
                                          group))
    out["heads"] = _np(ra.head_parallel_attention(*(t(a) for a in inp["heads"]), group))
    out["padded"] = _np(ra.sequence_parallel_attention(*(t(a) for a in inp["padded"]), group))

    q, k, v = (t(a).requires_grad_() for a in inp["grad"])
    (ra.sequence_parallel_attention(q, k, v, group) ** 2).sum().backward()
    out["grad"] = [_np(x.grad) for x in (q, k, v)]

    # the channels-major and heads-merged entries
    qt, kt, vt = (t(a).transpose(-1, -2) for a in inp["heads"])
    out["t_heads"] = _np(ra.mesh_attention_t(qt, kt, vt, ring, "heads"))
    out["t_ring"] = _np(ra.mesh_attention_t(qt, kt, vt, ring, "ring"))
    out["merged_ring"] = _np(ra.mesh_attention_merged(*(t(a) for a in inp["heads"]), ring, "ring"))

    # dispatch: no mesh, a trivial model axis, and data x model = 2 x 2 with
    # each data rank on its batch slice
    q, k, v = (t(a) for a in inp["dispatch"])
    out["dispatch_none"] = _np(ra.mesh_attention(q, k, v, None))
    flat = sharding.make_mesh(n, 1, device_type="cpu")
    out["dispatch_trivial"] = _np(ra.mesh_attention(q, k, v, flat))
    mesh = sharding.make_mesh(n, 2, device_type="cpu")
    mine = lambda a: sharding.shard_batch({"a": a}, mesh)["a"]  # noqa: E731
    out["dispatch_data"] = mesh["data"].get_local_rank()
    out["dispatch_heads"] = _np(ra.mesh_attention(mine(q), mine(k), mine(v), mesh, "heads"))
    out["dispatch_ring"] = _np(ra.mesh_attention(mine(q), mine(k), mine(v), mesh, "ring"))
    try:
        ra.mesh_attention(q[:, :3], k[:, :3], v[:, :3], mesh, "heads")
        out["odd_heads"] = None
    except ValueError as e:
        out["odd_heads"] = str(e)
    return out


def cli_world(rank, n, cwd, argv):
    """``cli/train.py main(argv)`` on this rank, from ``cwd``."""
    from multihmr_tpu_torch.cli.train import main

    os.chdir(cwd)
    main(argv)
    return rank


def swiglu_vit_tp(rank, world, vit_cfg, grid, path):
    """The channels-major SwiGLU ViT (``vit_cfg``, a ``grid`` x ``grid``
    patch grid, fp32) on a ``world``-rank model axis: its heads and FFN
    cut from the full state dict in ``path`` by ``shard_tensor``; the
    forward of the image batch there, as numpy."""
    from multihmr_tpu_torch.models.vit import DINOv2ViT
    from multihmr_tpu_torch.parallel.sharding import make_mesh, shard_tensor

    saved = torch.load(path)
    mesh = make_mesh(world, model_parallel=world, device_type="cpu")
    with torch.device("meta"):
        vit = DINOv2ViT(vit_cfg, grid, torch.float32, mesh=mesh)
    # the rules are written for the whole net's names, under backbone.
    state = {k: shard_tensor("backbone." + k, v, rank, world) for k, v in saved["state"].items()}
    vit.load_state_dict(state, strict=True, assign=True)
    with torch.no_grad():
        out = vit(saved["x"])
    return {k: _np(v) for k, v in out.items()}
