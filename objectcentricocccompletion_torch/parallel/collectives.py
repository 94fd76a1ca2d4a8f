"""The collectives of the model-parallel layouts, each an
``autograd.Function`` where the backward is not the forward's transpose by
itself (Megatron's f / g pair and their relatives).

Every function takes a process group (``None``: the default group, as in
``torch.distributed``) and is the identity on a group of one rank. A
collective that the group's backend does not serve raises
:class:`CollectiveNotServed`, which names it; nothing falls back to a
replicated computation. Gathers use ``all_gather`` of a tensor list and
reductions ``all_reduce``, which every backend serves on the CPU and, over
``gloo``, on CUDA tensors through the host; the reduce-scatter is
``reduce_scatter_tensor``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd import Function


class CollectiveNotServed(RuntimeError):
    """The backend of a group lacks a collective that a layout needs."""


def group_size(group=None) -> int:
    """The ranks of ``group``; 1 where no process group is up."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def _call(name: str, fn, *args, group=None, **kw):
    """``fn(*args, group=group, **kw)``; a backend's refusal of the
    collective raises :class:`CollectiveNotServed` naming it."""
    try:
        return fn(*args, group=group, **kw)
    except (RuntimeError, NotImplementedError) as e:
        msg = str(e).lower()
        if isinstance(e, NotImplementedError) or "support" in msg \
                or "implemented" in msg:
            raise CollectiveNotServed(
                f"{name} is not served by the {dist.get_backend(group)} "
                f"backend on {args[-1].device.type} tensors: {e}") from e
        raise


def all_reduce_(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """``x`` reduced in place over ``group``; returns it."""
    if group_size(group) > 1:
        _call("all_reduce", dist.all_reduce, x, op=op, group=group)
    return x


def all_gather_cat(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x``, concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    _call("all_gather", dist.all_gather, parts, x, group=group)
    return torch.cat(parts, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group=None
                       ) -> torch.Tensor:
    """The sum of every rank's ``x``, of which this rank keeps its chunk
    along ``dim`` (``x.shape[dim]`` divides by the group's size)."""
    n = group_size(group)
    if n == 1:
        return x
    inp = x.movedim(dim, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // n,) + inp.shape[1:])
    _call("reduce_scatter_tensor", dist.reduce_scatter_tensor, out, inp,
          group=group)
    return out.movedim(0, dim)


def all_reduce_coalesced_(tensors, group=None, scale: float = 1.0) -> None:
    """Sum each tensor of ``tensors`` over ``group`` in place, in one
    collective over their concatenation, then multiply by ``scale``."""
    tensors = list(tensors)
    if not tensors or (group_size(group) == 1 and scale == 1.0):
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    if scale != 1.0:
        flat.mul_(scale)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


class _CopyToGroup(Function):
    """f: the identity forward; the gradient summed over the group. A
    replicated tensor entering work that each rank does on its own part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _SumOverGroup(Function):
    """g: the sum over the group forward; the gradient as it is. Partial
    results becoming a replicated one."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MaxOverGroup(Function):
    """The elementwise max over the group; the gradient goes to the ranks
    that hold the max, split evenly among tied ranks."""

    @staticmethod
    def forward(ctx, x, group):
        y = all_reduce_(x.contiguous().clone(), group, dist.ReduceOp.MAX)
        ctx.group = group
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        held = (x == y).to(g.dtype)
        ties = all_reduce_(held.clone(), ctx.group)
        return g * held / ties, None


class _GatherLast(Function):
    """The column shards of every rank, concatenated along the last dim;
    the gradient's own columns (the consumers are replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.width = x.shape[-1]
        return all_gather_cat(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(-1, r * ctx.width, ctx.width), None


class _SliceDim(Function):
    """This rank's contiguous chunk of ``dim``; the gradient of every
    chunk gathered back (the input is replicated)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n, r = group_size(group), group_rank(group)
        ctx.dim, ctx.group = dim, group
        size = x.shape[dim] // n
        return x.narrow(dim, r * size, size)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None


class _GatherShards(Function):
    """A sharded parameter whole: every rank's chunk along ``dim``
    gathered; the gradient summed over the group, this rank's chunk
    kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def copy_to_group(x, group=None):
    return _CopyToGroup.apply(x, group) if group_size(group) > 1 else x


def sum_over_group(x, group=None):
    return _SumOverGroup.apply(x, group) if group_size(group) > 1 else x


def max_over_group(x, group=None):
    return _MaxOverGroup.apply(x, group) if group_size(group) > 1 else x


def gather_last(x, group=None):
    return _GatherLast.apply(x, group) if group_size(group) > 1 else x


def slice_dim(x, dim: int, group=None):
    return _SliceDim.apply(x, dim, group) if group_size(group) > 1 else x


def gather_shards(x, dim: int, group=None):
    return _GatherShards.apply(x, dim, group) if group_size(group) > 1 else x
