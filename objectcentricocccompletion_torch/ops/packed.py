"""Packed segment layout for per-RoI point workloads (counterpart of the
JAX package's ``ops/packed.py``).

The valid pooled points of all ``L`` frames of a tracklet compact into one
``[B, N]`` buffer with per-point segment (frame) ids, so every per-point
matmul and LayerNorm scales with the points a tracklet really has. Over
budget, the budget waterfills: every frame keeps up to the largest cap
``T`` with ``sum_l min(count_l, T) <= N``. In the block-aligned form each
frame starts at a multiple of ``quantum``, so every block belongs to one
frame and segment reductions are a dense per-block reduce plus a combine
over the few block results.

Every shape is static and nothing reads a value back to the host: the
binary searches run a fixed ``P.bit_length()`` steps on the device, and
the inverse permutation scatters into ``budget + 1`` slots whose spare one
takes the dropped points and is cut off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PackedPoints(NamedTuple):
    order: torch.Tensor      # [B, N] int64 indices into the flat [L*P]
    seg_ids: torch.Tensor    # [B, N] int64 frame id; == L when invalid
    valid: torch.Tensor      # [B, N] bool
    # block-aligned packing only: the segment of each quantum block,
    # [B, N // quantum]; None for tight packing
    block_seg: torch.Tensor | None = None


def _largest_fitting_cap(counts: torch.Tensor, P: int, fits
                         ) -> torch.Tensor:
    """The largest ``T`` in [0, P] with ``fits(T)`` per sample ([B]),
    by ``P.bit_length()`` steps of a binary search (fits(0) holds)."""
    B = counts.shape[0]
    lo = torch.zeros(B, dtype=counts.dtype, device=counts.device)
    hi = torch.full((B,), P, dtype=counts.dtype, device=counts.device)
    for _ in range(P.bit_length()):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        ok = fits(mid)
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid - 1)
    return lo


def waterfill_cap(mask: torch.Tensor, budget: int) -> torch.Tensor:
    """Keep each frame's first ``T`` valid points, ``T`` the largest cap
    with ``sum_l min(count_l, T) <= budget``; under-budget samples keep
    everything. mask [B, L, P] bool."""
    P = mask.shape[-1]
    counts = mask.sum(-1)                                   # [B, L]
    cap = _largest_fitting_cap(
        counts, P,
        lambda T: torch.minimum(counts, T[:, None]).sum(-1) <= budget)
    rank = mask.cumsum(-1) - 1                              # within frame
    return mask & (rank < cap[:, None, None])


def pack_groups(mask: torch.Tensor, budget: int) -> PackedPoints:
    """Tight packing: valid points of every frame to the front of a
    ``[B, budget]`` buffer in (frame, point) order; invalid slots carry
    segment ``L``. An over-budget sample is waterfilled."""
    B, L, P = mask.shape
    flat = waterfill_cap(mask, budget).reshape(B, L * P)
    # a stable sort of ~valid puts the valid points first, in order
    order = torch.argsort((~flat).to(torch.int32), dim=-1,
                          stable=True)[:, :budget]
    valid = torch.gather(flat, 1, order)
    seg_ids = torch.where(valid, torch.div(order, P, rounding_mode="floor"),
                          L)
    return PackedPoints(order, seg_ids, valid)


def _ceil_blocks(n: torch.Tensor, quantum: int) -> torch.Tensor:
    return torch.div(n + quantum - 1, quantum, rounding_mode="floor")


def pack_groups_aligned(mask: torch.Tensor, budget: int, quantum: int = 128
                        ) -> PackedPoints:
    """Block-aligned packing: each frame's points start at a
    ``quantum``-aligned slot, so each quantum block holds one frame. The
    waterfill counts each frame's aligned footprint
    (``sum_l ceil(min(c_l, T) / quantum) * quantum <= budget``)."""
    B, L, P = mask.shape
    if budget % quantum:
        raise ValueError(f"budget {budget} is not a multiple of {quantum}")
    if budget < L * quantum:
        raise ValueError(f"budget {budget} < {L} frames x quantum {quantum}")
    counts = mask.sum(-1)                                   # [B, L]
    cap = _largest_fitting_cap(
        counts, P,
        lambda T: (_ceil_blocks(torch.minimum(counts, T[:, None]), quantum)
                   * quantum).sum(-1) <= budget)
    kept = torch.minimum(counts, cap[:, None])              # [B, L]
    blocks = _ceil_blocks(kept, quantum)
    base = (blocks.cumsum(-1) - blocks) * quantum           # exclusive
    rank = mask.cumsum(-1) - 1
    keep = mask & (rank < cap[:, None, None])
    dest = torch.where(keep, base[..., None] + rank, budget)   # [B, L, P]
    # invert: slot d <- the flat point whose destination is d; the spare
    # slot ``budget`` takes every dropped point and is cut off
    flat_idx = torch.arange(L * P, device=mask.device).expand(B, L * P)
    inv = torch.full((B, budget + 1), -1, dtype=torch.int64,
                     device=mask.device)
    inv.scatter_(1, dest.reshape(B, L * P), flat_idx)
    inv = inv[:, :budget]
    filled = inv >= 0
    order = torch.where(filled, inv, 0)
    seg_ids = torch.where(filled, torch.div(order, P, rounding_mode="floor"),
                          L)
    block_seg = seg_ids.reshape(B, budget // quantum, quantum)[:, :, 0]
    return PackedPoints(order, seg_ids, filled, block_seg)


def segment_max_blocked(x: torch.Tensor, valid: torch.Tensor,
                        block_seg: torch.Tensor, num_segments: int,
                        neg: float = -1e30) -> torch.Tensor:
    """Segment max over the block-aligned layout: a masked max within each
    block, then a one-hot max over the block maxima. x [B, N, C],
    valid [B, N], block_seg [B, NB] -> [B, S, C]; empty segments give 0."""
    B, N, C = x.shape
    NB = block_seg.shape[1]
    q = N // NB
    xb = x.reshape(B, NB, q, C)
    vb = valid.reshape(B, NB, q, 1)
    bmax = torch.where(vb, xb, neg).amax(2)                  # [B, NB, C]
    oh = block_seg[..., None] == torch.arange(num_segments,
                                              device=x.device)  # [B, NB, S]
    out = torch.where(oh[..., None], bmax[:, :, None, :], neg).amax(1)
    return torch.where(oh.any(1)[..., None], out, 0.0)


def segment_mean_blocked(x: torch.Tensor, valid: torch.Tensor,
                         block_seg: torch.Tensor, num_segments: int
                         ) -> torch.Tensor:
    """Blocked counterpart of :func:`segment_mean`."""
    B, N, C = x.shape
    NB = block_seg.shape[1]
    q = N // NB
    bsum = torch.where(valid[..., None], x, 0.0).reshape(B, NB, q, C).sum(2)
    bcnt = valid.reshape(B, NB, q).sum(2)                     # [B, NB]
    oh = (block_seg[..., None] == torch.arange(
        num_segments, device=x.device)).to(x.dtype)           # [B, NB, S]
    s = torch.einsum("bns,bnc->bsc", oh, bsum)
    n = torch.einsum("bns,bn->bs", oh, bcnt.to(x.dtype))
    return s / n[..., None].clamp(min=1)


def pack_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Per-point rows into the packed layout: x [B, L, P, C] or [B, L, P],
    order [B, N] -> [B, N, C] or [B, N]."""
    B, L, P = x.shape[:3]
    if x.dim() == 3:
        return torch.gather(x.reshape(B, L * P), 1, order)
    C = x.shape[3]
    return torch.gather(x.reshape(B, L * P, C), 1,
                        order[..., None].expand(B, order.shape[1], C))


def segment_max(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                neg: float = -1e30) -> torch.Tensor:
    """Max over each segment by a one-hot broadcast compare; empty segments
    give 0. x [B, N, C], seg_ids [B, N] (invalid rows carry an id >=
    num_segments) -> [B, S, C]."""
    oh = seg_ids[..., None] == torch.arange(num_segments,
                                            device=x.device)  # [B, N, S]
    out = torch.where(oh[..., None], x[:, :, None, :], neg).amax(1)
    return torch.where(oh.any(1)[..., None], out, 0.0)


def segment_sum(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
                ) -> torch.Tensor:
    """One-hot-matmul segment sum. x [B, N, C] -> [B, S, C]."""
    oh = (seg_ids[..., None] == torch.arange(
        num_segments, device=x.device)).to(x.dtype)
    return torch.einsum("bns,bnc->bsc", oh, x)


def segment_mean(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
                 ) -> torch.Tensor:
    oh = (seg_ids[..., None] == torch.arange(
        num_segments, device=x.device)).to(x.dtype)
    s = torch.einsum("bns,bnc->bsc", oh, x)
    n = oh.sum(1)[..., None]
    return s / n.clamp(min=1)


def segment_any(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[B, S] bool: the segment has at least one packed point."""
    return (seg_ids[..., None] == torch.arange(
        num_segments, device=seg_ids.device)).any(1)


def broadcast_back(g: torch.Tensor, seg_ids: torch.Tensor) -> torch.Tensor:
    """Per-segment rows back to their points: [B, S, C], [B, N] ->
    [B, N, C]. Invalid ids clamp; callers mask those rows."""
    B, S, C = g.shape
    ids = seg_ids.clamp(0, S - 1)
    return torch.gather(g, 1, ids[..., None].expand(B, ids.shape[1], C))


def broadcast_back_blocked(g: torch.Tensor, block_seg: torch.Tensor,
                           n_points: int) -> torch.Tensor:
    """Blocked broadcast-back: one row per block, repeated within it.
    [B, S, C], [B, NB] -> [B, n_points, C]."""
    B, S, C = g.shape
    NB = block_seg.shape[1]
    ids = block_seg.clamp(0, S - 1)
    gb = torch.gather(g, 1, ids[..., None].expand(B, NB, C))   # [B, NB, C]
    return gb[:, :, None, :].expand(B, NB, n_points // NB, C).reshape(
        B, n_points, C)
