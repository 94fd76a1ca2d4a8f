"""Sparse window partitioning for SST, static shapes, sort-based.

Counterpart of ``objectcentricocccompletion_tpu/ops/window.py``: voxels sort
(stably) by window id; the in-window rank is ``position - first position of
the window`` (a running max, ``torch.cummax``); windows compact to a fixed
``max_windows`` buffer and tokens scatter to a dense
``[max_windows, capacity]`` layout with a validity mask. Tokens beyond the
capacity and windows beyond the budget are dropped (slot -1). Window slots
and ranks equal the JAX package's exactly.

SST's blocks run on flat voxel rows and use the windowed layout only for
the attention core: :func:`window_level` lays out a level once per shift,
:func:`to_windows` scatters rows into its buffers and :func:`from_windows`
gathers them back.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch


class WindowPartition(NamedTuple):
    win_of_voxel: torch.Tensor   # [V] compact window slot (-1 dropped)
    rank_in_win: torch.Tensor    # [V] token slot within window (-1 dropped)
    coors_in_win: torch.Tensor   # [V, 3] (x, y, z) position in the window
    num_windows: torch.Tensor    # [] int64


def _num_windows_per_axis(sparse_shape, window_shape):
    return [math.ceil(s / w) + 1 for s, w in zip(sparse_shape, window_shape)]


def window_ids(coords: torch.Tensor, valid: torch.Tensor, sparse_shape,
               window_shape, shifted: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-voxel window key + in-window coords; coords [V, 3] (x, y, z)."""
    nx, ny, nz = _num_windows_per_axis(sparse_shape, window_shape)
    wx, wy, wz = window_shape
    if shifted:
        ox, oy, oz = wx // 2, wy // 2, wz // 2
    else:
        ox, oy, oz = wx, wy, wz
    if sparse_shape[2] == wz:
        oz = 0
    dev = coords.device
    sc = coords + torch.tensor([ox, oy, oz], dtype=coords.dtype, device=dev)
    w = torch.tensor([wx, wy, wz], dtype=coords.dtype, device=dev)
    wc = torch.div(sc, w, rounding_mode="floor")
    key = wc[:, 0] * (ny * nz) + wc[:, 1] * nz + wc[:, 2]
    key = torch.where(valid, key, nx * ny * nz + 1)
    return key, torch.remainder(sc, w)


def partition(coords: torch.Tensor, valid: torch.Tensor, sparse_shape,
              window_shape, shifted: bool, max_windows: int,
              capacity: int) -> WindowPartition:
    v = coords.shape[0]
    dev = coords.device
    key, inwin = window_ids(coords, valid, sparse_shape, window_shape,
                            shifted)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    nx, ny, nz = _num_windows_per_axis(sparse_shape, window_shape)
    ok = skey <= nx * ny * nz
    first = torch.ones_like(ok)
    first[1:] = skey[1:] != skey[:-1]
    first &= ok
    win_slot_sorted = torch.cumsum(first, 0) - 1
    num_windows = first.sum()
    idx = torch.arange(v, device=dev)
    first_pos = torch.cummax(torch.where(first, idx, 0), 0).values
    rank_sorted = idx - first_pos

    keep = ok & (win_slot_sorted < max_windows) & (rank_sorted < capacity)
    win_of_voxel = torch.empty(v, dtype=torch.long, device=dev)
    win_of_voxel[order] = torch.where(keep, win_slot_sorted, -1)
    rank_in_win = torch.empty(v, dtype=torch.long, device=dev)
    rank_in_win[order] = torch.where(keep, rank_sorted, -1)
    return WindowPartition(win_of_voxel, rank_in_win, inwin, num_windows)


def window_counts(part: WindowPartition, max_windows: int) -> torch.Tensor:
    """[max_windows] token count per compact window slot."""
    ok = part.win_of_voxel >= 0
    seg = torch.where(ok, part.win_of_voxel, max_windows)
    return torch.bincount(seg, minlength=max_windows + 1)[:max_windows]


def split_by_occupancy(part: WindowPartition, max_windows: int,
                       small_capacity: int, max_small: int,
                       max_large: int
                       ) -> tuple[WindowPartition, WindowPartition]:
    """Two-level drop-level batching: windows with <= ``small_capacity``
    tokens batch at the small capacity, the rest at the full one. Returns
    (small, large) partitions with compacted window slots."""
    counts = window_counts(part, max_windows)
    occupied = counts > 0
    is_small = occupied & (counts <= small_capacity)
    is_large = occupied & ~is_small
    small_slot = torch.cumsum(is_small, 0) - 1
    large_slot = torch.cumsum(is_large, 0) - 1

    w = part.win_of_voxel
    safe = w.clamp(0, max_windows - 1)
    valid = w >= 0

    def level(is_level, slot, budget):
        inside = valid & is_level[safe] & (slot[safe] < budget)
        return WindowPartition(
            torch.where(inside, slot[safe], -1),
            torch.where(inside, part.rank_in_win, -1), part.coors_in_win,
            torch.clamp(is_level.sum(), max=budget))

    return (level(is_small, small_slot, max_small),
            level(is_large, large_slot, max_large))


def flat_to_window(feats: torch.Tensor, part: WindowPartition,
                   max_windows: int, capacity: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """[V, C] -> ([max_windows, capacity, C], token mask). Dropped tokens,
    and any slot outside the buffer, land in a spare window that is sliced
    off."""
    w, r = part.win_of_voxel, part.rank_in_win
    ok = (w >= 0) & (r >= 0) & (w < max_windows) & (r < capacity)
    w = torch.where(ok, w, max_windows)
    r = torch.where(ok, r, 0)
    out = feats.new_zeros((max_windows + 1, capacity, feats.shape[-1]))
    out[w, r] = torch.where(ok[:, None], feats, 0.0)
    m = torch.zeros((max_windows + 1, capacity), dtype=torch.bool,
                    device=feats.device)
    m[w, r] = ok
    return out[:max_windows], m[:max_windows]


def window_to_flat(wfeats: torch.Tensor, part: WindowPartition
                   ) -> torch.Tensor:
    """[max_windows, capacity, C] -> [V, C]; dropped voxels get zeros."""
    ok = (part.win_of_voxel >= 0) & (part.rank_in_win >= 0)
    w = part.win_of_voxel.clamp(0, wfeats.shape[0] - 1)
    r = part.rank_in_win.clamp(0, wfeats.shape[1] - 1)
    return torch.where(ok[:, None], wfeats[w, r], 0.0)


class WindowLevel(NamedTuple):
    """One level of a shift's partition, laid out once for every layer of
    the shift: where each voxel's token sits in the level's
    ``[max_windows, capacity]`` buffer, and the buffer's token mask."""
    part: WindowPartition
    slot: torch.Tensor     # [V] w * capacity + rank; outside the level, a
    #                        slot of the spare window past the buffer's end
    source: torch.Tensor   # [V] the slot each voxel reads back: its own,
    #                        else one picked by its index
    kept: torch.Tensor     # [V] bool: the level holds the voxel's token
    mask: torch.Tensor     # [max_windows, capacity] bool token mask


def window_level(part: WindowPartition, max_windows: int,
                 capacity: int) -> WindowLevel:
    w, r = part.win_of_voxel, part.rank_in_win
    kept = (w >= 0) & (r >= 0) & (w < max_windows) & (r < capacity)
    n = max_windows * capacity
    # voxels outside the level spread over the spare window's slots as they
    # write, and over the buffer as they read, so that neither the scatter
    # nor the backward's adds pile onto one row
    idx = torch.arange(len(w), device=w.device)
    slot = torch.where(kept, w * capacity + r, n + idx % capacity)
    source = torch.where(kept, slot, idx % n)
    m = torch.zeros(n + capacity, dtype=torch.bool, device=w.device)
    m[slot] = kept
    return WindowLevel(part, slot, source, kept,
                       m[:n].view(max_windows, capacity))


def to_windows(level: WindowLevel, feats: Sequence[torch.Tensor]
               ) -> list[torch.Tensor]:
    """Each [V, C] of ``feats`` -> the level's zeroed
    [max_windows, capacity, C] buffer holding its tokens; one scatter for
    all of them."""
    W, T = level.mask.shape
    rows = torch.stack(list(feats))
    buf = rows.new_zeros((len(feats), (W + 1) * T, rows.shape[-1]))
    buf[:, level.slot] = rows
    return [b[:W * T].view(W, T, -1) for b in buf]


def from_windows(wfeats: torch.Tensor, level: WindowLevel,
                 other: torch.Tensor | float) -> torch.Tensor:
    """[max_windows, capacity, C] -> [V, C]: each voxel's token of the
    level; voxels outside the level take ``other``."""
    rows = wfeats.reshape(-1, wfeats.shape[-1]).index_select(0, level.source)
    return torch.where(level.kept[:, None], rows, other)
