"""Submanifold and strided sparse 3D convolution as a gather-GEMM
(counterpart of the JAX package's ``ops/sparse_conv.py``).

Active voxels sit in buffers padded to a static budget, with validity masks.
A neighbour table ``[K, V]`` holds, for each output voxel and kernel offset,
the slot of the input voxel there or -1. It is resolved through a dense
int32 map from the linearised voxel key to its slot (one scatter, O(1)
gathers) or, for grids of more than ``DENSE_INDEX_MAX_CELLS`` cells, a
binary search over the sorted keys. The convolution gathers the K neighbour
rows of every output voxel and multiplies them with the ``[K, Cin, Cout]``
kernel in one GEMM; misses gather a zero row and contribute exactly 0.

Every index equals the JAX package's. Where JAX clamps an out-of-range
gather or drops an out-of-range scatter (``mode="drop"``), the port clamps
or masks explicitly, or writes into one spare row past the end that is then
sliced off. Keys are int64 here (the JAX package's int32 keys never
overflow: ``_keys`` asserts it); the dense map stays int32 (362 MB at the
full CenterPoint grid of 1504 x 1504 x 40 cells).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class SparseGrid(NamedTuple):
    """A set of active voxels with a search structure."""
    coords: torch.Tensor          # [V, 3] int64 (x, y, z)
    valid: torch.Tensor           # [V] bool
    sorted_keys: torch.Tensor     # [V] int64 (invalid -> sentinel key)
    sorted_to_slot: torch.Tensor  # [V] int64: slot in coords of each key
    grid_shape: tuple             # (gx, gy, gz)
    # [1 + gx*gy*gz + 3] int32 key + 1 -> slot (-1 empty); None for grids
    # of more than DENSE_INDEX_MAX_CELLS cells
    dense_index: torch.Tensor | None = None


def _keys(coords: torch.Tensor, valid: torch.Tensor, grid_shape
          ) -> torch.Tensor:
    """Linearised keys x * gy * gz + y * gz + z (int64); invalid rows get
    the sentinel gx * gy * gz + 1."""
    gx, gy, gz = grid_shape
    if int(gx) * int(gy) * int(gz) + 1 >= 2 ** 31:
        raise ValueError(f"voxel grid {grid_shape} overflows int32 keys")
    c = coords.long()
    key = c[:, 0] * (gy * gz) + c[:, 1] * gz + c[:, 2]
    return torch.where(valid, key, gx * gy * gz + 1)


# the dense map is used up to this many cells (int32: 512 MB at 2^27)
DENSE_INDEX_MAX_CELLS = 2 ** 27


def build_grid(coords: torch.Tensor, valid: torch.Tensor,
               grid_shape: Sequence[int],
               dense_index: bool | None = None) -> SparseGrid:
    """``dense_index``: force (True / False) or auto (None: dense when the
    grid has at most ``DENSE_INDEX_MAX_CELLS`` cells)."""
    grid_shape = tuple(int(g) for g in grid_shape)
    n_cells = grid_shape[0] * grid_shape[1] * grid_shape[2]
    if dense_index is None:
        dense_index = n_cells <= DENSE_INDEX_MAX_CELLS
    key = _keys(coords, valid, grid_shape)
    dev = coords.device
    if dense_index:
        V = coords.shape[0]
        # layout: [1 lead pad][n_cells cells][3 tail pad]. The lead pad
        # keeps z-triple slices that start at cell -1 in bounds; invalid
        # rows carry the sentinel key n_cells + 1 into the tail pad, which
        # lookup masks through the query's validity
        dense = torch.full((n_cells + 4,), -1, dtype=torch.int32,
                           device=dev)
        dense[key + 1] = torch.arange(V, dtype=torch.int32, device=dev)
        empty = torch.zeros((0,), dtype=torch.long, device=dev)
        return SparseGrid(coords, valid, empty, empty, grid_shape, dense)
    order = torch.argsort(key, stable=True)
    return SparseGrid(coords, valid, key[order], order, grid_shape, None)


def lookup(grid: SparseGrid, query_coords: torch.Tensor,
           query_valid: torch.Tensor) -> torch.Tensor:
    """Slot (into ``grid.coords``) of each query coord, or -1 if absent;
    int64."""
    gx, gy, gz = grid.grid_shape
    hi = torch.tensor([gx, gy, gz], device=query_coords.device)
    in_bounds = ((query_coords >= 0) & (query_coords < hi)).all(-1)
    qv = query_valid & in_bounds
    qkey = _keys(query_coords, qv, grid.grid_shape)
    if grid.dense_index is not None:
        n = grid.dense_index.shape[0]
        slot = grid.dense_index[(qkey + 1).clamp(0, n - 1)].long()
        # qv already excludes out-of-bounds queries, whose sentinel key
        # points at the pad slots beyond the cells
        return torch.where(qv & (qkey < n), slot, -1)
    n = grid.sorted_keys.shape[0]
    pos = torch.searchsorted(grid.sorted_keys, qkey).clamp(0, n - 1)
    hit = (grid.sorted_keys[pos] == qkey) & qv
    return torch.where(hit, grid.sorted_to_slot[pos], -1)


def kernel_offsets(ksize: int | Sequence[int]) -> np.ndarray:
    if isinstance(ksize, int):
        ksize = (ksize,) * 3
    rr = [np.arange(k) - k // 2 for k in ksize]
    return np.stack(np.meshgrid(*rr, indexing="ij"), -1).reshape(-1, 3)


def neighbor_table(grid: SparseGrid, out_coords: torch.Tensor,
                   out_valid: torch.Tensor, offsets: np.ndarray,
                   stride: int = 1) -> torch.Tensor:
    """``[K, V]`` int64 input slot per kernel offset and output voxel, -1
    for a miss. Submanifold (stride 1): in = out + offset; strided: the
    caller passes output coords in the downsampled lattice and in = out *
    stride + offset (the offsets include the padding shift).

    When the offsets come in z-consecutive triples (every 3^3 cube; z is the
    innermost key) and the grid has a dense map, each (dx, dy) group reads
    one 3-wide slice of the map instead of three single cells."""
    offsets = np.asarray(offsets)
    K = len(offsets)
    V = out_coords.shape[0]
    dev = out_coords.device
    oc = out_coords.long()
    if grid.dense_index is not None and _z_triples(offsets):
        gx, gy, gz = grid.grid_shape
        g_off = torch.as_tensor(offsets[::3], dtype=torch.long, device=dev)
        q = oc[None, :, :] * stride + g_off[:, None, :]      # [K/3, V, 3]
        x, y, z0 = q[..., 0], q[..., 1], q[..., 2]
        # raw key of the dz0 neighbour; the slice stays aligned even where
        # the triple starts at cell z = -1 (the lead pad) or the column is
        # out of bounds (masked below)
        key0 = x * (gy * gz) + y * gz + z0
        n = grid.dense_index.shape[0]
        start = (key0.reshape(-1) + 1).clamp(0, n - 3)
        tri = torch.arange(3, device=dev)
        rows = grid.dense_index[start[:, None] + tri].long()  # [K/3*V, 3]
        slots = rows.reshape(K // 3, V, 3).transpose(1, 2)
        xy_ok = ((x >= 0) & (x < gx) & (y >= 0) & (y < gy)
                 & out_valid[None, :])                        # [K/3, V]
        zq = z0[:, None, :] + tri[None, :, None]
        ok = xy_ok[:, None, :] & (zq >= 0) & (zq < gz)        # [K/3, 3, V]
        return torch.where(ok, slots, -1).reshape(K, V)
    q = oc[None, :, :] * stride + torch.as_tensor(
        offsets, dtype=torch.long, device=dev)[:, None, :]
    qv = out_valid[None, :].expand(K, V)
    return lookup(grid, q.reshape(K * V, 3), qv.reshape(K * V)).reshape(K, V)


def _z_triples(offsets: np.ndarray) -> bool:
    """True if consecutive offset triples share (dx, dy) and step z by +1
    with dz0 >= -1 (so the slice start stays within the lead pad)."""
    if len(offsets) % 3 != 0:
        return False
    o = offsets.reshape(-1, 3, 3)
    return bool(
        np.all(o[:, 0, :2] == o[:, 1, :2]) and np.all(o[:, 1, :2] == o[:, 2, :2])
        and np.all(o[:, 1, 2] == o[:, 0, 2] + 1)
        and np.all(o[:, 2, 2] == o[:, 1, 2] + 1)
        and np.all(o[:, 0, 2] >= -1))


def sparse_conv_apply(feats: torch.Tensor, table: torch.Tensor,
                      weights: torch.Tensor, out_valid: torch.Tensor
                      ) -> torch.Tensor:
    """feats [V_in, Cin]; table [K, V]; weights [K, Cin, Cout] -> [V, Cout].

    The K neighbour rows of each output voxel, gathered from ``feats``,
    form a ``[V, K * Cin]`` matrix: one GEMM with the kernel reshaped to
    ``[K * Cin, Cout]``. Misses read zero rows appended to ``feats``, one
    per output voxel. The gather is an ``index_select``, whose gradient is
    an atomic ``index_add_`` of the ``[V * K, Cin]`` rows: advanced
    indexing's gradient sorts its indices and serialises the duplicates
    (one shared zero row took 99% of a full-width training step on the
    H100), and one zero row per output voxel keeps the misses' adds spread
    as thin as the hits'. Invalid output rows are 0."""
    v_in, cin = feats.shape
    K, V = table.shape
    cout = weights.shape[2]
    padded = torch.cat([feats, feats.new_zeros(V, cin)], 0)
    own = v_in + torch.arange(V, device=table.device)
    idx = torch.where(table >= 0, table, own).t().reshape(-1)  # [V * K]
    gathered = padded.index_select(0, idx).reshape(V, K * cin)
    out = gathered @ weights.reshape(K * cin, cout).to(feats.dtype)
    return torch.where(out_valid[:, None], out, 0.0)


def _lattice_candidates(grid: SparseGrid, ksize: int, stride: int,
                        padding: int):
    """Every (input voxel, kernel offset) candidate of a strided conv's
    output lattice: coords [K * V, 3], validity [K * V] and the output
    grid shape."""
    gx, gy, gz = grid.grid_shape
    ogs = tuple((g + 2 * padding - ksize) // stride + 1 for g in (gx, gy, gz))
    dev = grid.coords.device
    offs = torch.as_tensor(
        np.stack(np.meshgrid(*([np.arange(ksize)] * 3), indexing="ij"),
                 -1).reshape(-1, 3), dtype=torch.long, device=dev)
    hi = torch.tensor(ogs, device=dev)
    # [K, V, 3]; integer // and % floor, as jnp's do (the numerator
    # reaches -1)
    num = grid.coords.long()[None] + padding - offs[:, None, :]
    div_ok = (num % stride == 0).all(-1)
    oc = num // stride
    in_rng = ((oc >= 0) & (oc < hi)).all(-1)
    cval = grid.valid[None] & div_ok & in_rng
    return oc.reshape(-1, 3), cval.reshape(-1), ogs


def downsample_coords(grid: SparseGrid, ksize: int, stride: int,
                      padding: int, max_out: int
                      ) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """Output lattice of a strided sparse conv: the exact spconv output set
    {(i + padding - k) / stride : k in [0, ksize), divisible, in range}, in
    key order, cut to ``max_out`` (the rest drop silently; see
    :func:`count_downsampled`).

    Returns (out_coords [max_out, 3] int64, out_valid [max_out],
    out_grid_shape)."""
    cand, cval, ogs = _lattice_candidates(grid, ksize, stride, padding)
    ogx, ogy, ogz = ogs
    n_cells = ogx * ogy * ogz
    dev = cand.device
    key = cand[:, 0] * (ogy * ogz) + cand[:, 1] * ogz + cand[:, 2]
    key = torch.where(cval, key, n_cells)
    # dedup and rank through a dense occupancy map and its cumsum
    occ = torch.zeros((n_cells + 1,), dtype=torch.int32, device=dev)
    occ[key] = 1
    csum = torch.cumsum(occ, 0)
    n_out = csum[n_cells - 1]
    slot = torch.where(cval, csum[key] - 1, max_out).clamp(max=max_out)
    out_coords = torch.zeros((max_out + 1, 3), dtype=torch.long, device=dev)
    out_coords[slot] = cand          # duplicates write equal rows
    out_valid = torch.arange(max_out, device=dev) < n_out.clamp(max=max_out)
    return out_coords[:max_out], out_valid, ogs


def count_downsampled(grid: SparseGrid, ksize: int, stride: int,
                      padding: int) -> int:
    """Occupied cells of :func:`downsample_coords`'s output lattice before
    the budget cuts it (reading it synchronises)."""
    cand, cval, (ogx, ogy, ogz) = _lattice_candidates(grid, ksize, stride,
                                                      padding)
    key = cand[:, 0] * (ogy * ogz) + cand[:, 1] * ogz + cand[:, 2]
    return torch.unique(key[cval]).numel()


def strided_conv_offsets(ksize: int, padding: int) -> np.ndarray:
    """Input-lattice offsets of a strided conv: in = out * stride + k -
    padding."""
    offs = np.stack(np.meshgrid(*([np.arange(ksize)] * 3), indexing="ij"),
                    -1).reshape(-1, 3)
    return offs - padding


def scatter_to_dense(feats: torch.Tensor, coords: torch.Tensor,
                     valid: torch.Tensor, grid_shape) -> torch.Tensor:
    """Sparse voxels -> dense ``[gx, gy, gz, C]`` canvas (spconv's
    ``SparseConvTensor.dense()``); invalid rows drop."""
    gx, gy, gz = (int(g) for g in grid_shape)
    n = gx * gy * gz
    c = coords.long()
    idx = torch.where(valid, c[:, 0] * (gy * gz) + c[:, 1] * gz + c[:, 2], n)
    vals = torch.where(valid[:, None], feats, 0.0)
    out = feats.new_zeros((n + 1, feats.shape[-1])).index_put((idx,), vals)
    return out[:n].reshape(gx, gy, gz, -1)
