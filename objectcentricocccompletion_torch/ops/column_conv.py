"""Column-dense sparse 3D convolution: z kept dense in every active (x, y)
column (counterpart of the JAX package's ``ops/column_conv.py``).

A LiDAR grid is sparse in (x, y) and shallow in z (40 cells at stage 0 of
CenterPoint, 5 by stage 3), so this layout holds each active column whole:

    feats: [N_cols, gz, C]   occ: [N_cols, gz] active-voxel mask

A 3 x 3 x 3 convolution then gathers nine whole columns per output column
(rows of ``gz * C`` contiguous elements) and runs z as a dense width-3
convolution. Inactive cells hold zeros and the outputs are masked by
``occ``, so every active voxel's result is the submanifold (or strided)
convolution's, the gather layout's of ``ops/sparse_conv.py``; the kernels
are the same ``[27, Cin, Cout]`` tensors, so both layouts read one
parameter tree.

Every function keeps the JAX function's name and contract. Out-of-range
writes that JAX drops (``mode="drop"``) go to a spare row that is cut off;
column budgets truncate as in JAX (the highest linearised (x, y) keys go
first). The z-convolution returns float32 sums of exact products whatever
the activation dtype, as JAX's ``preferred_element_type=float32`` does: a
bf16 operand is widened to float32 (exactly) before the GEMM, so the card's
TF32 setting cannot round it; float32 operands follow
``torch.backends.cuda.matmul.allow_tf32``, off by default and off in every
entry point of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.nn import functional as F

# the 3 x 3 (dx, dy) taps of a column, dx outermost: kernel_offsets(3)'s
# order with dz innermost, so tap k = 3 dx + dy owns kernel rows 3 k .. 3 k + 2
_TAPS_2D = np.stack(np.meshgrid(np.arange(3), np.arange(3), indexing="ij"),
                    -1).reshape(-1, 2)


class ColumnGrid(NamedTuple):
    """Active (x, y) columns of a sparse voxel grid, z kept dense."""
    col_xy: torch.Tensor      # [N, 2] int64
    col_valid: torch.Tensor   # [N] bool
    occ: torch.Tensor         # [N, gz] bool active-voxel mask
    grid_shape: tuple         # (gx, gy, gz)
    col_index: torch.Tensor   # [gx * gy + 1] 2D cell -> column slot, -1 empty


def _key2d(xy: torch.Tensor, valid: torch.Tensor, gx: int, gy: int
           ) -> torch.Tensor:
    key = xy[..., 0].long() * gy + xy[..., 1].long()
    return torch.where(valid, key, gx * gy)


def _columns_of(key: torch.Tensor, n_cells: int, max_cols: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot of each key's column in key order, ``max_cols`` where the key
    is the sentinel ``n_cells`` or past the budget; occupied columns before
    the cut, a 0-d tensor)."""
    occ2d = torch.zeros(n_cells + 1, dtype=torch.long, device=key.device)
    occ2d[key] = 1
    csum = torch.cumsum(occ2d, 0)
    slot = torch.where(key < n_cells, csum[key] - 1, max_cols)
    return slot.clamp(max=max_cols), csum[n_cells - 1]


def _column_index(col_xy: torch.Tensor, col_valid: torch.Tensor, gx: int,
                  gy: int) -> torch.Tensor:
    n_cells = gx * gy
    ckey = _key2d(col_xy, col_valid, gx, gy)
    col_index = torch.full((n_cells + 1,), -1, dtype=torch.long,
                           device=col_xy.device)
    col_index[ckey] = torch.arange(col_xy.shape[0], device=col_xy.device)
    # the sentinel cell may have been written by invalid columns
    col_index[n_cells] = -1
    return col_index


def build_columns(coords: torch.Tensor, valid: torch.Tensor,
                  grid_shape: Sequence[int], max_cols: int
                  ) -> tuple[ColumnGrid, torch.Tensor]:
    """Collapse active voxels [V, 3] into their (x, y) columns.

    Returns (grid, col_of_voxel [V]): each input voxel's column slot,
    ``max_cols`` where it is invalid or dropped. Columns order by
    linearised (x, y) key; past ``max_cols`` the highest keys drop."""
    grid, col_of, _ = _build_columns(coords, valid, grid_shape, max_cols)
    return grid, col_of


def _build_columns(coords, valid, grid_shape, max_cols):
    """:func:`build_columns` and the occupied columns before the cut (a
    0-d tensor)."""
    gx, gy, gz = (int(g) for g in grid_shape)
    dev = coords.device
    key = _key2d(coords, valid, gx, gy)
    col_of, n_cols = _columns_of(key, gx * gy, max_cols)
    kept = col_of < max_cols
    col_xy = torch.zeros((max_cols + 1, 2), dtype=torch.long, device=dev)
    col_xy[col_of] = coords[:, :2].long()
    col_xy = col_xy[:max_cols]
    col_valid = torch.arange(max_cols, device=dev) < n_cols.clamp(
        max=max_cols)
    cell = torch.where(kept, col_of * gz + coords[:, 2].long(),
                       max_cols * gz)
    occ = torch.zeros(max_cols * gz + 1, dtype=torch.bool, device=dev)
    occ[cell] = valid
    occ = occ[:-1].view(max_cols, gz) & col_valid[:, None]
    return (ColumnGrid(col_xy, col_valid, occ, (gx, gy, gz),
                       _column_index(col_xy, col_valid, gx, gy)), col_of,
            n_cols)


def scatter_voxel_feats(feats: torch.Tensor, coords: torch.Tensor,
                        col_of_voxel: torch.Tensor, max_cols: int,
                        gz: int) -> torch.Tensor:
    """[V, C] voxel features -> [max_cols, gz, C] column-dense tensor."""
    cell = torch.where(col_of_voxel < max_cols,
                       col_of_voxel * gz + coords[:, 2].long(),
                       max_cols * gz)
    out = feats.new_zeros(max_cols * gz + 1, feats.shape[-1]).index_copy(
        0, cell, feats)
    return out[:-1].view(max_cols, gz, feats.shape[-1])


def neighbor_columns(grid: ColumnGrid, out_xy: torch.Tensor | None = None,
                     out_valid: torch.Tensor | None = None,
                     stride: int = 1, pad: int = 1) -> torch.Tensor:
    """[9, N] column slot of each 3 x 3 (dx, dy) neighbour, -1 when absent.

    ``out_xy`` defaults to the grid's own columns (submanifold). For a
    strided conv pass the OUTPUT columns: neighbour (kx, ky) of output
    column o sits at ``o * stride + k - pad`` in the input lattice."""
    gx, gy, _ = grid.grid_shape
    if out_xy is None:
        out_xy, out_valid = grid.col_xy, grid.col_valid
        base = out_xy - pad
    else:
        base = out_xy * stride - pad
    offs = torch.as_tensor(_TAPS_2D, device=base.device)
    q = base[None, :, :] + offs[:, None, :]                     # [9, N, 2]
    ok = (out_valid[None, :] & (q >= 0).all(-1) & (q[..., 0] < gx)
          & (q[..., 1] < gy))
    slot = grid.col_index[_key2d(q, ok, gx, gy)]
    return torch.where(ok, slot, -1)


def _pad_rows(feats: torch.Tensor, zero_rows: int = 1) -> torch.Tensor:
    """[N, gz, C] -> [N + zero_rows, gz * C] flat rows, the trailing
    ``zero_rows`` zero (JAX appends one). Whole columns are gathered as
    these rows with ``index_select``, whose gradient is an ``index_add_``:
    advanced indexing's gradient sorts its indices and serialises the
    duplicates instead."""
    N, gz, C = feats.shape
    flat = feats.reshape(N, gz * C)
    return torch.cat([flat, flat.new_zeros(zero_rows, gz * C)], 0)


def _gather_columns_padded(padded: torch.Tensor, slots: torch.Tensor,
                           gz: int, missing: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """padded [N + z, gz * C] (zero rows from N on), slots [M] (-1
    missing) -> [M, gz, C]. A missing slot reads the last row, or where
    ``missing`` [M] is given the row it names (one zero row per output
    keeps the gradient's adds of the misses as spread as the hits')."""
    idx = torch.where(slots >= 0, slots,
                      padded.shape[0] - 1 if missing is None else missing)
    g = padded.index_select(0, idx)
    return g.view(slots.shape[0], gz, padded.shape[1] // gz)


def _gather_columns(feats: torch.Tensor, slots: torch.Tensor
                    ) -> torch.Tensor:
    """feats [N, gz, C], slots [M] (-1 missing) -> [M, gz, C], zeros when
    missing."""
    return _gather_columns_padded(_pad_rows(feats), slots, feats.shape[1])


def _zconv(g: torch.Tensor, w: torch.Tensor, stride: int,
           padding: tuple[int, int]) -> torch.Tensor:
    """Dense width-3 convolution over z, float32: g [N, *T, gz, Cin], w
    [*T, 3, Cin, Cout] -> [N, gz', Cout], summed over the leading taps
    ``T`` too (JAX's contract is ``T = ()``; :func:`conv3x3x3` passes its
    nine (dx, dy) taps). The weights are rounded to ``g``'s dtype as in JAX,
    and the windows of all taps form one ``[N gz', |T| 3 Cin]`` float32
    matrix: one GEMM accumulates every product in float32."""
    pl, ph = padding
    if pl or ph:
        g = F.pad(g, (0, 0, pl, ph))
    n, cout = g.shape[0], w.shape[-1]
    win = g.unfold(-2, 3, stride)                   # [N, *T, gz', Cin, 3]
    win = win.movedim(-3, 1).transpose(-1, -2)      # [N, gz', *T, 3, Cin]
    rows = win.new_empty(win.shape, dtype=torch.float32)
    rows.copy_(win)
    out_w = rows.shape[1]
    wf = w.to(g.dtype).float().reshape(-1, cout)
    return (rows.view(n * out_w, -1) @ wf).view(n, out_w, cout)


def conv3x3x3(feats: torch.Tensor, nbrs: torch.Tensor, w: torch.Tensor,
              out_occ: torch.Tensor, stride: int = 1,
              z_padding: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """3 x 3 x 3 sparse convolution in column layout, float32.

    feats [N_in, gz, Cin]; nbrs [9, N_out] input-column slot per (dx, dy)
    tap; w [27, Cin, Cout] in ``kernel_offsets(3)`` order ((dx, dy, dz), dx
    outermost: the gather layout's kernels); out_occ [N_out, gz_out].
    Returns [N_out, gz_out, Cout] masked to the active set.

    The columns are padded in z first, then one ``index_select`` gathers
    the nine neighbours of every output column and :func:`_zconv` runs the
    27 taps as one GEMM."""
    n_in, gz, cin = feats.shape
    m = nbrs.shape[1]
    fp = F.pad(feats, (0, 0, *z_padding))
    own = n_in + torch.arange(m, device=nbrs.device)
    g = _gather_columns_padded(_pad_rows(fp, m), nbrs.t().reshape(-1),
                               fp.shape[1], own.repeat_interleave(9))
    out = _zconv(g.view(m, 9, fp.shape[1], cin),
                 w.reshape(9, 3, cin, w.shape[-1]), stride, (0, 0))
    return torch.where(out_occ[..., None], out, 0.0)


def downsample_columns(grid: ColumnGrid, max_out_cols: int
                       ) -> tuple[ColumnGrid, torch.Tensor]:
    """Output lattice of a k3 s2 p1 strided conv, column form.

    Output columns: every (x', y') with ``x' = (x + 1 - kx) / 2`` reachable
    from an active input column (the gather layout's output set restricted
    to (x, y)), the highest keys dropped past ``max_out_cols``; output occ
    from the same rule over z through the 3 x 3 neighbour table. Returns
    (out_grid, nbrs [9, N_out] into the INPUT grid's columns)."""
    out_grid, nbrs, _ = _downsample(grid, max_out_cols)
    return out_grid, nbrs


def _downsample(grid: ColumnGrid, max_out_cols: int):
    """:func:`downsample_columns` and the occupied output columns before
    the cut (a 0-d tensor)."""
    gx, gy, gz = grid.grid_shape
    ogx, ogy, ogz = ((g + 2 - 3) // 2 + 1 for g in (gx, gy, gz))
    dev = grid.col_xy.device
    offs = torch.as_tensor(_TAPS_2D, device=dev)
    num = grid.col_xy[None] + 1 - offs[:, None]                 # [9, N, 2]
    ok = (grid.col_valid[None] & (num % 2 == 0).all(-1) & (num >= 0).all(-1)
          & (num[..., 0] // 2 < ogx) & (num[..., 1] // 2 < ogy))
    cand = (num // 2).reshape(-1, 2)
    cval = ok.reshape(-1)
    slot, n_out = _columns_of(_key2d(cand, cval, ogx, ogy), ogx * ogy,
                              max_out_cols)
    out_xy = torch.zeros((max_out_cols + 1, 2), dtype=torch.long, device=dev)
    out_xy[slot] = cand
    out_xy = out_xy[:max_out_cols]
    out_valid = torch.arange(max_out_cols, device=dev) < n_out.clamp(
        max=max_out_cols)

    nbrs = neighbor_columns(grid, out_xy, out_valid, stride=2, pad=1)

    # out occ: OR over the 27 taps of the input occ (the 9 neighbour
    # columns' occ, then a stride-2 OR over z windows)
    occ_in = (grid.occ[nbrs.clamp(0, grid.occ.shape[0] - 1)]
              & (nbrs >= 0)[..., None])                         # [9, N, gz]
    occ_any = F.pad(occ_in.any(0), (1, 1))                      # [N, gz + 2]
    out_occ = (occ_any[:, 0:2 * ogz - 1:2][:, :ogz]
               | occ_any[:, 1:2 * ogz:2][:, :ogz]
               | occ_any[:, 2:2 * ogz + 1:2][:, :ogz]) & out_valid[:, None]
    out_grid = ColumnGrid(out_xy, out_valid, out_occ, (ogx, ogy, ogz),
                          _column_index(out_xy, out_valid, ogx, ogy))
    return out_grid, nbrs, n_out


def zcompress(feats: torch.Tensor, occ: torch.Tensor, w: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(3, 1, 1)-kernel stride-(2, 1, 1) padding-0 conv (``conv_out``): z
    compression only. feats [N, gz, C], w [3, C, D] -> ([N, gz', D] float32,
    occ' [N, gz'])."""
    gz = feats.shape[1]
    ogz = (gz - 3) // 2 + 1
    out_occ = (occ[:, 0:2 * ogz - 1:2][:, :ogz]
               | occ[:, 1:2 * ogz:2][:, :ogz]
               | occ[:, 2:2 * ogz + 1:2][:, :ogz])
    out = _zconv(feats, w, 2, (0, 0))[:, :ogz]
    return torch.where(out_occ[..., None], out, 0.0), out_occ


def columns_to_bev(feats: torch.Tensor, grid: ColumnGrid) -> torch.Tensor:
    """[N, gz, C] -> dense BEV [gx, gy, C * gz], channel-major per z slice
    (channel c * gz + z, the gather layout's BEV channels)."""
    gx, gy, gz = grid.grid_shape
    C = feats.shape[-1]
    rows = feats.transpose(1, 2).reshape(feats.shape[0], C * gz)
    rows = torch.where(grid.col_valid[:, None], rows, 0.0)
    key = _key2d(grid.col_xy, grid.col_valid, gx, gy)
    canvas = rows.new_zeros(gx * gy + 1, C * gz).index_copy(0, key, rows)
    return canvas[:gx * gy].view(gx, gy, C * gz)


def column_counts(coords: torch.Tensor, valid: torch.Tensor,
                  grid_shape: Sequence[int], budgets: Sequence[int]
                  ) -> list[int]:
    """Occupied columns of each stage's lattice before its budget cuts it
    (host ints; synchronises): the voxels' columns, then each k3 s2 p1
    downsample of the previous stage's cut grid."""
    grid, _, n = _build_columns(coords, valid, grid_shape, budgets[0])
    counts = [n]
    for b in budgets[1:]:
        grid, _, n = _downsample(grid, b)
        counts.append(n)
    return [int(n) for n in counts]
