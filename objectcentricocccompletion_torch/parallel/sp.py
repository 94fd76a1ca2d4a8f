"""Sequence parallelism: each rank of the 'model' mesh axis works on its
contiguous slice of the packed point axis and of the occupancy decoder's
query axis (counterpart of the JAX package's ``parallel/sp.py``).

The flagship's activation memory scales with the packed point budget
(``[B, N, C]``) and the decoder's query set (``[B, L, K, C]``). Under SP a
rank keeps ``N / tp`` points and ``K / tp`` queries. Where the JAX package
annotates a sharding and lets XLA partition, the port slices and names
each crossing by hand:

- :func:`shard_seq` keeps this rank's slice of a replicated tensor (its
  gradient is gathered back);
- inside :func:`region` every activation is this rank's slice of
  ``seq_dim``: dropout draws the global batch's mask elements there
  (``models/layers.py::dropout``), a column-parallel Dense gathers its
  weight (``parallel/train.py::ColumnParallel``), and the packed segment
  reductions combine their per-frame tables over the model group
  (``ops/packed.py``);
- :func:`to_shards` is a replicated tensor read by the slices (its
  gradient is summed over the model group), :func:`complete_sum` a sum
  over the slices (the occupancy loss and its counts).

A replicated parameter that reads sliced activations gets its gradient
summed over the model group after the backward (``parallel/train.py``).

The setting lives only while a step runs (``make_train_step`` sets and
clears it), so a step built afterwards is unconstrained; every helper is
the identity while it is unset, so model code is layout-agnostic.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from . import collectives as cc

_SP: list = [None]       # (mesh, axis name) | None
_REGION: list = [None]   # Region | None


class Region(NamedTuple):
    """Activations hold ``[offset, offset + length)`` of ``total`` along
    ``dim``."""
    dim: int
    offset: int
    total: int


def set_sequence_parallel(mesh, axis: str = "model") -> None:
    """Shard the sequence axes over ``axis`` of ``mesh`` (a
    ``DeviceMesh``) until :func:`clear_sequence_parallel`."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"sequence parallelism needs a {axis!r} mesh axis; "
                         f"the mesh has {mesh.mesh_dim_names}")
    _SP[0] = (mesh, axis)


def clear_sequence_parallel() -> None:
    _SP[0] = None
    _REGION[0] = None


def sequence_parallel_enabled() -> bool:
    return _SP[0] is not None


def group():
    """The model group while SP is set, else None."""
    if _SP[0] is None:
        return None
    mesh, axis = _SP[0]
    return mesh.get_group(axis)


def size() -> int:
    """The ranks that share the sequence (1 while SP is unset)."""
    return 1 if _SP[0] is None else cc.group_size(group())


def seq_slice(total: int, quantum: int = 1) -> tuple[int, int]:
    """``(offset, length)`` of this rank's slice of a sequence of
    ``total``; the slices fall on multiples of ``quantum`` (the packed
    layout's blocks)."""
    n = size()
    if total % (n * quantum):
        raise ValueError(f"sequence parallelism over {n} ranks: a sequence "
                         f"of {total} does not split into {n} slices of "
                         f"whole {quantum}-blocks")
    length = total // n
    return cc.group_rank(group()) * length if n > 1 else 0, length


def shard_seq(x: torch.Tensor, seq_dim: int) -> torch.Tensor:
    """This rank's slice of ``seq_dim`` of ``x`` (``x`` replicated); the
    identity while SP is unset."""
    if size() == 1:
        return x
    seq_slice(x.shape[seq_dim])
    return cc.slice_dim(x, seq_dim, group())


@contextlib.contextmanager
def region(seq_dim: int, offset: int, total: int):
    """Mark the activations made inside as slices of ``seq_dim``
    (``[offset, offset + total / size)`` of ``total``)."""
    prev = _REGION[0]
    _REGION[0] = Region(seq_dim, offset, total)
    try:
        yield
    finally:
        _REGION[0] = prev


def current_region() -> Region | None:
    return _REGION[0]


def _active() -> bool:
    return _REGION[0] is not None and size() > 1


def to_shards(table: torch.Tensor) -> torch.Tensor:
    """A replicated tensor read by this rank's slice: its gradient is
    summed over the model group (Megatron's f)."""
    if not _active() or not table.requires_grad:
        return table
    return cc.copy_to_group(table, group())


def complete_sum(x: torch.Tensor) -> torch.Tensor:
    """A partial sum over this rank's slice completed over the model group
    (Megatron's g; its gradient is the replicated one)."""
    if size() == 1:
        return x
    return cc.sum_over_group(x, group())


def combine_max(table: torch.Tensor) -> torch.Tensor:
    """Per-segment maxima of the slices into the sequence's, inside a
    region."""
    return cc.max_over_group(table, group()) if _active() else table


def combine_sum(table: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of the slices into the sequence's, inside a
    region."""
    return cc.sum_over_group(table, group()) if _active() else table
