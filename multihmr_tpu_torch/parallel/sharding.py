"""The (data, model) device mesh and the layout of the weights on it
(``multihmr_tpu/parallel/sharding.py``).

One rank per device (``torchrun``, or ``torch.multiprocessing`` spawning
ranks), each holding its own shard of the weights:

  * **tensor parallelism** over the ``model`` axis, Megatron's pairing in
    the ViT blocks (the JAX ``_TP_RULES``): ``qkv`` and ``fc1`` are
    column-parallel (each rank keeps its share of the output rows), ``proj``
    and ``fc2`` row-parallel (its share of the input columns, the bias added
    once after the all-reduce). The qkv split follows the heads: rank ``r``
    of ``P`` keeps the rows ``t·D + h·Dh + d`` of its ``H/P`` heads for each
    of q, k and v, so its ``[B, 3·D/P, N]`` output reshapes with no copy to
    the ``[B, 3, H/P, Dh, N]`` operand of K1 (the JAX rule ``P(None,
    "model")`` splits the 3·D columns into contiguous blocks and XLA
    reshards them before the attention; the numbers are the same). The
    SwiGLU FFN of a port-only backbone (``port_config.py``) pairs ``w12``
    (column: rank ``r`` keeps the rows ``t·H + j`` of its ``H/P`` share
    of each half ``t`` of x1 and x2, so its output's halves match) with
    ``w3`` (row), which the JAX package has no rule for. Every
    other parameter is replicated, and so are all weights with
    ``tp_mode="ring"``, where the ViT shards the sequence instead (the JAX
    rules shard the dense weights in ring mode too);
  * **data parallelism** over ``data``: each rank of a ``model`` group gets
    the same slice of the batch; the gradients are summed over ``data``;
  * **FSDP** over ``data`` (``fsdp=True``): :func:`apply_fsdp` hands the
    leaves of ``fsdp_min_size`` elements or more to FSDP2's ``fully_shard``,
    which shards them (and so the Adam moments, created like them) on dim
    0. The JAX package shards the largest free divisible dim instead.

``constrain_batch`` (JAX ``:108``) has no counterpart: the tokens at the
ViT→HPH boundary are replicated over ``model`` and split over ``data`` by
construction, since every rank runs the head on its own batch slice.

:func:`shard_state_dict` cuts a full state dict (as ``io/convert.py::
params_from_jax`` or a single-device net gives it) into one rank's shards,
:func:`gather_state_dict` puts a sharded net's weights back together; the
checkpoints and the tests go through both.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.distributed as dist

# Megatron rules of the ViT blocks, by parameter name (the port's names,
# weights stored [out, in]): "heads" keeps the rank's heads' q, k and v rows,
# "halves" the rank's share of each of the SwiGLU w12's two halves (x1's
# rows and the matching x2 rows), 0 a contiguous share of dim 0
# (column-parallel), 1 of dim 1 (row-parallel)
_TP_RULES = [
    (re.compile(r"backbone\..*attn\.qkv\.(weight|bias)$"), "heads"),
    (re.compile(r"backbone\..*attn\.proj\.weight$"), 1),
    (re.compile(r"backbone\..*mlp\.fc1\.(weight|bias)$"), 0),
    (re.compile(r"backbone\..*mlp\.fc2\.weight$"), 1),
    (re.compile(r"backbone\..*mlp\.w12\.(weight|bias)$"), "halves"),
    (re.compile(r"backbone\..*mlp\.w3\.weight$"), 1),
]
# the rules that cut dim 0 into equal parts (q, k, v; x1, x2) and shard each
_PARTS = {"heads": 3, "halves": 2}
# the parameters of the sequence-sharded blocks (tp_mode="ring"): each rank's
# gradient holds its tokens' share only
_SEQUENCE_SHARDED = re.compile(r"backbone\.blocks\.")


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: Optional[str] = None):
    """The 2D (data, model) ``DeviceMesh`` over the ranks of the initialised
    process group (``model_parallel=1`` is pure data parallelism). One rank
    per device: ``n_devices`` (default the world size) must be the world
    size. ``device_type`` defaults to "cuda" where torch sees a card. A CUDA
    rank selects its device before this call (``torch.cuda.set_device``)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"one rank per device: n_devices={n} but the process group has "
                         f"{world} ranks (launch with torchrun --nproc_per_node {n})")
    if n % model_parallel:
        raise ValueError(f"n_devices={n} is not divisible by model_parallel={model_parallel}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def axis_size(mesh, axis: str) -> int:
    """Size of a mesh axis; 1 without a mesh."""
    return 1 if mesh is None else mesh[axis].size()


def axis_group(mesh, axis: str):
    """The process group of this rank along ``axis``, or None where the axis
    has a single rank (nothing to communicate)."""
    return mesh[axis].get_group() if axis_size(mesh, axis) > 1 else None


def tp_rule(name: str):
    """The TP rule of a parameter name: "heads", "halves", 0, 1, or None
    (replicated)."""
    for rule, how in _TP_RULES:
        if rule.search(name):
            return how
    return None


def shard_tensor(name: str, t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s TP shard of the full parameter ``name``."""
    how = tp_rule(name)
    if how is None or size == 1:
        return t
    if how in _PARTS:  # e.g. [3D, ...] → rows (t, this rank's heads, d) → [3·D/P, ...]
        parts = t.reshape((_PARTS[how], t.shape[0] // _PARTS[how]) + t.shape[1:])
        return parts.chunk(size, 1)[rank].reshape((-1,) + t.shape[1:]).contiguous()
    return t.chunk(size, how)[rank].contiguous()


def unshard_tensors(name: str, shards: list) -> torch.Tensor:
    """The full parameter from every rank's TP shard, in rank order."""
    how = tp_rule(name)
    if how is None or len(shards) == 1:
        return shards[0]
    if how in _PARTS:
        n = _PARTS[how]
        parts = [s.reshape((n, s.shape[0] // n) + s.shape[1:]) for s in shards]
        full = torch.cat(parts, 1)
        return full.reshape((-1,) + full.shape[2:])
    return torch.cat(shards, how)


def tp_sharded(mesh, tp_mode: str) -> bool:
    """Whether the ViT's dense weights are TP-sharded on this mesh."""
    return tp_mode == "heads" and axis_size(mesh, "model") > 1


def shard_state_dict(state: dict, mesh, tp_mode: str = "heads") -> dict:
    """This rank's TP shards of a full state dict (replicated leaves as
    they are; everything replicated with ``tp_mode="ring"``)."""
    if not tp_sharded(mesh, tp_mode):
        return dict(state)
    rank, size = mesh["model"].get_local_rank(), axis_size(mesh, "model")
    return {k: shard_tensor(k, v, rank, size) for k, v in state.items()}


def _full_local(t: torch.Tensor) -> torch.Tensor:
    """An FSDP-sharded parameter (a DTensor sharded on dim 0 over one mesh
    axis) gathered whole on every rank of that axis; a plain tensor as it is.
    Gathered on padded equal chunks, those FSDP2 cuts (``torch.chunk``)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    mesh, full0 = t.device_mesh, t.shape[0]
    n = mesh.size()
    local = t.to_local()
    chunk = -(-full0 // n)
    if n == 1:
        return local
    padded = local.new_zeros((chunk,) + local.shape[1:])
    padded[:local.shape[0]].copy_(local)
    out = local.new_empty((n * chunk,) + local.shape[1:])
    dist.all_gather(list(out.chunk(n)), padded, group=mesh.get_group())
    return out[:full0]


def gather_tensor(name: str, t: torch.Tensor, mesh, tp_mode: str) -> torch.Tensor:
    """The full tensor of parameter ``name`` (or of a moment shaped like it)
    from this rank's shard: FSDP gathered over ``data``, TP over ``model``.
    A collective: every rank of the mesh calls it, in the same order."""
    t = _full_local(t.detach())
    if tp_sharded(mesh, tp_mode) and tp_rule(name) is not None:
        t = t.contiguous()
        shards = [torch.empty_like(t) for _ in range(axis_size(mesh, "model"))]
        dist.all_gather(shards, t, group=mesh["model"].get_group())
        t = unshard_tensors(name, shards)
    return t


def gather_state_dict(net: torch.nn.Module, mesh, tp_mode: str) -> dict:
    """The full state dict (single-device names and shapes, on the CPU) of a
    net on the mesh. A collective: every rank calls it."""
    return {k: gather_tensor(k, v, mesh, tp_mode).cpu() for k, v in net.state_dict().items()}


def local_piece(name: str, full: torch.Tensor, like: torch.Tensor, mesh,
                tp_mode: str) -> torch.Tensor:
    """This rank's piece of the full tensor ``full`` of parameter ``name``,
    laid out as ``like`` (the rank's parameter or moment): the TP shard, then
    for a DTensor the dim-0 chunk of its mesh axis, as a DTensor. No
    communication: every rank holds ``full``."""
    from torch.distributed.tensor import DTensor

    if tp_sharded(mesh, tp_mode):
        full = shard_tensor(name, full, mesh["model"].get_local_rank(),
                            axis_size(mesh, "model"))
    if not isinstance(like, DTensor):
        return full.to(device=like.device, dtype=like.dtype)
    m = like.device_mesh
    c = -(-full.shape[0] // m.size())  # FSDP2's torch.chunk pieces (the last ones may be short)
    piece = full[m.get_local_rank() * c:(m.get_local_rank() + 1) * c]
    return DTensor.from_local(piece.to(device=like.to_local().device, dtype=like.dtype), m,
                              like.placements, run_check=False, shape=full.shape,
                              stride=full.stride())


@torch.no_grad()
def load_full_state_dict(net: torch.nn.Module, state: dict, mesh, tp_mode: str) -> None:
    """Load a full (single-device) state dict into a net on the mesh, strictly:
    each rank copies in its own piece."""
    own = net.state_dict()
    missing, unexpected = own.keys() - state.keys(), state.keys() - own.keys()
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(unexpected)[:5]}")
    from torch.distributed.tensor import DTensor

    for k, t in own.items():
        piece = local_piece(k, state[k], t, mesh, tp_mode)
        if isinstance(t, DTensor):
            t.to_local().copy_(piece.to_local())
        else:
            t.copy_(piece)


def gather_optimizer_state(optimizer: torch.optim.Optimizer, net: torch.nn.Module, mesh,
                           tp_mode: str) -> dict:
    """The optimizer's state dict as a single-device optimizer over
    ``net.parameters()`` would hold it: one parameter group, indexed in the
    net's parameter order, every moment whole. A collective."""
    names = [n for n, _ in net.named_parameters()]
    by_param = {id(p): n for n, p in net.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if sorted(by_param.get(id(p), "") for p in params) != sorted(names):
        raise ValueError("the optimizer must hold exactly the net's parameters")
    state = {}
    for p in params:
        name = by_param[id(p)]
        st = optimizer.state.get(p, {})
        state[names.index(name)] = {
            k: (gather_tensor(name, v, mesh, tp_mode).cpu()
                if isinstance(v, torch.Tensor) and v.dim() > 0 else v)
            for k, v in st.items()}
    group = {k: v for k, v in optimizer.param_groups[0].items() if k != "params"}
    group["params"] = list(range(len(names)))
    return {"state": state, "param_groups": [group]}


def load_full_optimizer_state(optimizer: torch.optim.Optimizer, net: torch.nn.Module,
                              full: dict, mesh, tp_mode: str) -> None:
    """Load a single-device optimizer state dict (as
    :func:`gather_optimizer_state` or a single-device run writes it) into an
    optimizer over the net's parameters on the mesh."""
    named = list(net.named_parameters())
    if len(full["param_groups"]) != 1 or len(full["param_groups"][0]["params"]) != len(named):
        raise ValueError("expected a one-group optimizer state over the net's parameters")
    hyper = {k: v for k, v in full["param_groups"][0].items() if k != "params"}
    for g in optimizer.param_groups:
        g.update(hyper)
    optimizer.state.clear()
    for i, (name, p) in enumerate(named):
        st = full["state"].get(i, full["state"].get(str(i)))
        if st is None:
            continue
        optimizer.state[p] = {
            k: (local_piece(name, v, p, mesh, tp_mode)
                if isinstance(v, torch.Tensor) and v.dim() > 0 else v.clone())
            for k, v in st.items()}


def param_groups(net: torch.nn.Module) -> list:
    """The net's parameters as optimizer groups, the FSDP-sharded ones
    (DTensors) apart from the rest: a multi-tensor (foreach) optimizer step
    takes no group that mixes the two."""
    from torch.distributed.tensor import DTensor

    params = list(net.parameters())
    groups = [[p for p in params if isinstance(p, DTensor)],
              [p for p in params if not isinstance(p, DTensor)]]
    return [{"params": g} for g in groups if g]


def apply_fsdp(net: torch.nn.Module, mesh, fsdp_min_size: int = 1 << 16) -> set:
    """FSDP2 over ``data`` for the parameters of ``fsdp_min_size`` elements
    or more (smaller ones stay replicated: their collectives would cost more
    than the bytes saved). Gradients are summed over ``data``, not averaged:
    each rank's loss already divides by the whole batch's counts
    (train/loss.py). Returns the names of the sharded parameters."""
    from torch.distributed.fsdp import fully_shard

    small = {p for p in net.parameters() if p.numel() < fsdp_min_size}
    names = {n for n, p in net.named_parameters() if p.numel() >= fsdp_min_size}
    if not names:
        return names
    fully_shard(net, mesh=mesh["data"], ignored_params=small, reshard_after_forward=True)
    net.set_gradient_divide_factor(1.0)
    net.set_force_sum_reduction_for_comms(True)  # a plain SUM: gloo has no PREMUL_SUM or AVG
    return names


def sync_gradients(net: torch.nn.Module, mesh, tp_mode: str, fsdp_names=frozenset()) -> None:
    """Complete each rank's gradients after the backward pass: sum over
    ``data`` those FSDP did not reduce, and over ``model`` those of the
    sequence-sharded blocks (``tp_mode="ring"``), with one all-reduce per
    axis and dtype on a flat buffer."""
    plans = []
    if axis_size(mesh, "data") > 1:
        plans.append(("data", lambda n: n not in fsdp_names))
    if tp_mode == "ring" and axis_size(mesh, "model") > 1:
        plans.append(("model", lambda n: _SEQUENCE_SHARDED.search(n) is not None))
    for axis, wanted in plans:
        grads = {}
        for n, p in net.named_parameters():
            if p.grad is not None and wanted(n):
                g = p.grad
                g = g.to_local() if hasattr(g, "to_local") else g
                grads.setdefault(g.dtype, []).append(g)
        for gs in grads.values():
            flat = torch.cat([g.reshape(-1) for g in gs])
            dist.all_reduce(flat, group=mesh[axis].get_group())
            offset = 0
            for g in gs:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()


def clip_grad_norm(net: torch.nn.Module, max_norm: float, mesh, tp_mode: str) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` over the whole model on the mesh:
    the global norm counts each TP-sharded leaf once across ``model``, each
    FSDP leaf once across ``data`` and each replicated leaf once in all.
    Scales the gradients by ``max_norm / (norm + 1e-6)`` where that is below
    1; returns the norm."""
    from torch.distributed.tensor import DTensor

    tp = tp_sharded(mesh, tp_mode)
    named = [(n, p.grad) for n, p in net.named_parameters() if p.grad is not None]
    local = lambda g: g.to_local() if isinstance(g, DTensor) else g  # noqa: E731
    # squared norms by how the leaf is sharded: [TP and FSDP, TP, FSDP, replicated]
    sums = torch.zeros(4, dtype=torch.float64, device=local(named[0][1]).device)
    for n, g in named:
        fsdp = isinstance(g, DTensor)
        slot = (0 if fsdp else 1) if tp and tp_rule(n) is not None else (2 if fsdp else 3)
        sums[slot] += local(g).double().pow(2).sum()
    if axis_size(mesh, "data") > 1:
        part = sums[[0, 2]].clone()
        dist.all_reduce(part, group=mesh["data"].get_group())
        sums[0], sums[2] = part[0], part[1]
    if tp:
        part = sums[[0, 1]].clone()
        dist.all_reduce(part, group=mesh["model"].get_group())
        sums[0], sums[1] = part[0], part[1]
    norm = sums.sum().sqrt()
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for _, g in named:
        local(g).mul_(coef.to(g.dtype))
    return norm


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's slice of a global batch along dim 0 (its ``data``
    coordinate; every rank of a ``model`` group gets the same slice)."""
    n = axis_size(mesh, "data")
    if n == 1:
        return batch
    d = mesh["data"].get_local_rank()
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k} of {v.shape[0]} does not divide over the data "
                             f"axis ({n})")
        b = v.shape[0] // n
        out[k] = v[d * b:(d + 1) * b]
    return out
