"""The collectives of the multi-rank paths, as autograd functions.

The JAX package has no counterpart: under ``jit`` on a ``Mesh`` XLA inserts
its collectives. Here each rank runs its own program, and the model calls
these at the seams of its sharded regions (Megatron's f and g operators,
the ring's shift and the sequence gather):

  * :func:`copy_to_model`: identity forward, all-reduce backward (the input
    of a column-parallel layer: every rank's heads add to its gradient);
  * :func:`reduce_from_model`: all-reduce forward, identity backward (the
    output of a row-parallel layer);
  * :func:`ring_shift`: send to the next rank and receive from the previous
    one; the backward sends the other way;
  * :func:`split` and :func:`gather`: this rank's slice along a dim, and the
    all-gather along it; each is the other's backward.

Every collective runs on the process group it is given, through
``torch.distributed`` and nothing else. A group of one rank is a no-op.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Number of ranks in ``group``."""
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group``."""
    return dist.get_rank(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, out of place."""
    if group_size(group) == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on and receive from the one
    ``step`` places back, in the group's own rank order."""
    n = group_size(group)
    if n == 1:
        return x
    me = group_rank(group)
    to = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to, group), dist.P2POp(dist.irecv, out, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    dist.all_gather(list(out.chunk(n)), x, group=group)
    return out.movedim(0, dim)


def _split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    return x.chunk(n, dim)[group_rank(group)].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _split(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``group``."""
    return _CopyToModel.apply(x, group) if torch.is_grad_enabled() else x


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the backward passes the gradient through."""
    return _ReduceFromModel.apply(x, group) if torch.is_grad_enabled() else all_reduce(x, group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The previous rank's ``x`` (rank r receives from r - 1 and sends to
    r + 1, modulo the group's size)."""
    return _RingShift.apply(x, group) if torch.is_grad_enabled() else _shift(x, group, 1)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` in rank order; the backward takes this rank's
    slice of the gradient (every rank computes the same thing downstream)."""
    return _Gather.apply(x, dim, group) if torch.is_grad_enabled() else _gather(x, dim, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` (equal slices); the backward
    all-gathers the gradient, so what precedes the split stays replicated."""
    return _Split.apply(x, dim, group) if torch.is_grad_enabled() else _split(x, dim, group)
