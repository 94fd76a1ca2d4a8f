"""Masked reductions (counterpart of the JAX package's ``ops/masked.py``):
dense groups laid out as ``[..., item, channel]`` with a validity mask, and
ragged segments given by a segment id per row.

The segment reductions scatter (``index_add`` / ``scatter_reduce``): no
one-hot ``[N, S, C]`` is formed. Segment ids lie in ``[0, num_segments)``;
callers send rows to drop to a spare segment they slice off.
:func:`gather_rows` is the gather back to the rows."""
from __future__ import annotations

import torch

_NEG = -1e30


def _expand(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a [..., items] mask against x [..., items, channels]."""
    return mask[..., None] if mask.dim() == x.dim() - 1 else mask


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int
               ) -> torch.Tensor:
    """Max over ``dim`` of the ``mask``-true items; 0 for an empty group."""
    m = _expand(mask, x)
    out = torch.where(m, x, _NEG).amax(dim)
    return torch.where(m.any(dim), out, 0.0)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int
                ) -> torch.Tensor:
    """Mean over ``dim`` of the ``mask``-true items; 0 for an empty group."""
    m = _expand(mask, x)
    s = torch.where(m, x, 0.0).sum(dim)
    n = m.sum(dim)
    return s / n.clamp(min=1)


def segment_sum(x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment sum of the rows of ``x`` [N, ...] -> [num_segments,
    ...]; 0 for an empty segment."""
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    return out.index_add(0, segment_ids, x)


def segment_mean(x: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment mean of the rows of ``x`` [N, C]; 0 for an empty
    segment."""
    s = segment_sum(x, segment_ids, num_segments)
    n = torch.bincount(segment_ids, minlength=num_segments)
    return s / n.clamp(min=1)[:, None].to(x.dtype)


def segment_max(x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max of the rows of ``x`` [N, C]; 0 for an empty segment
    and where the max is not finite. The gradient of a maximum that
    several rows share is split equally among them, as ``jax.grad`` of
    ``jax.ops.segment_max`` splits it."""
    idx = segment_ids[:, None].expand(x.shape)
    out = x.new_zeros((num_segments, x.shape[1])).scatter_reduce(
        0, idx, x, "amax", include_self=False)
    return torch.where(torch.isfinite(out), out, 0.0)


def gather_rows(x: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
    """``x[idx]`` where ``valid``, else 0: rows [len(idx), ...].

    An ``index_select`` from ``x`` with one zero row appended per output
    row, which each invalid output reads: the gradient is an atomic
    ``index_add_`` whose adds spread over distinct rows. (Advanced indexing
    ``x[idx.clamp(...)]`` sends every invalid row to one shared row, and
    its CUDA backward sorts the indices and adds each run of duplicates
    serially.)"""
    n = idx.shape[0]
    padded = torch.cat([x, x.new_zeros((n,) + tuple(x.shape[1:]))], 0)
    own = x.shape[0] + torch.arange(n, device=idx.device)
    return padded.index_select(0, torch.where(valid, idx, own))
