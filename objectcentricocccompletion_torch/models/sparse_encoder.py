"""Sparse 3D encoder, CenterPoint's middle encoder (counterpart of the JAX
package's ``models/sparse_encoder.py``), on two layouts that share one
parameter tree:

    conv_input: SubM(k3) base -> base
    stage i (i = 0..3): [SparseConv k3 s2 p1 downsample when i > 0] +
                        residual SubM basic blocks per encoder_channels[i]
    conv_out:  SparseConv (3, 1, 1) stride (2, 1, 1) compressing z
    dense:     scatter to the BEV map [1, D * C, gx, gy], channel c * D + z

- ``layout="gather"``: the gather-GEMMs of ``ops/sparse_conv.py`` (27 row
  gathers per voxel and convolution), float32 whatever ``dtype`` and
  ``remat_blocks`` say, in both packages;
- ``layout="column"``: ``ops/column_conv.py`` (9 whole-column gathers per
  output column, z dense), its activations in ``dtype`` (the convolutions
  sum in float32; LayerNorm and the BEV map stay float32), each residual
  block recomputed in the backward under ``remat_blocks``.

Budgets per stage are static and what exceeds them drops silently, as in
the JAX package: voxels in the gather layout (``voxel_occupancy`` reports
how full each runs), columns in the column layout
(``max_columns_per_stage``, by default the voxel budgets). A frame that
overflows a column budget gives the two layouts different results, in both
packages. LayerNorm (eps 1e-3) stands in for BN1d.

Module and parameter names are the flax ones: sparse kernels are
``[K, Cin, Cout]`` parameters named ``kernel``, ``conv2_kernel``,
``down{i}_kernel`` and ``conv_out_kernel``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import column_conv as cc
from ..ops import sparse_conv as sc
from ..ops.routes import relu
from .layers import LN_EPS, dense, layer_norm

OFFSETS_27 = sc.kernel_offsets(3)
STRIDED_OFFSETS = sc.strided_conv_offsets(3, 1)
# conv_out's input offsets (0, 0, k), k = 0..2: in = (x, y, 2 z + k)
CONV_OUT_OFFSETS = np.stack([np.zeros(3, np.int64), np.zeros(3, np.int64),
                             np.arange(3)], -1)


class GatherCtx(NamedTuple):
    """Connectivity of one stage in the gather-GEMM layout."""
    table: torch.Tensor   # [27, V]
    valid: torch.Tensor   # [V]

    def conv(self, feats: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return sc.sparse_conv_apply(feats, self.table, w, self.valid)

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.valid[:, None], x, 0.0)


class ColumnCtx(NamedTuple):
    """Connectivity of one stage in the column-dense layout."""
    nbrs: torch.Tensor    # [9, N] column slots
    occ: torch.Tensor     # [N, gz]

    def conv(self, feats: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return cc.conv3x3x3(feats, self.nbrs, w, self.occ)

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.occ[..., None], x, 0.0)


def _kernel(k: int, cin: int, cout: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(k, cin, cout))


def _norm_act(norm: nn.LayerNorm, x: torch.Tensor, valid: torch.Tensor
              ) -> torch.Tensor:
    return torch.where(valid[:, None], relu(layer_norm(norm, x)), 0.0)


class SubMConv(nn.Module):
    """Submanifold 3^3 convolution -> LayerNorm -> ReLU, masked. The
    convolution runs in ``dtype`` (its kernel cast to it; float32 by
    default) and the result leaves in ``dtype``; LayerNorm statistics stay
    float32."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = _kernel(27, in_channels, out_channels)
        self.LayerNorm_0 = nn.LayerNorm(out_channels, eps=LN_EPS)

    def forward(self, feats: torch.Tensor, ctx) -> torch.Tensor:
        x = ctx.conv(feats.to(self.dtype), self.kernel)
        return ctx.mask(relu(layer_norm(self.LayerNorm_0, x))).to(self.dtype)


class SparseBasicBlock(nn.Module):
    """Residual block of two SubM convs (the reference's
    ``SparseBasicBlock``); a bias-free ``proj`` where the width changes.
    Computes in ``dtype`` as :class:`SubMConv` does."""

    def __init__(self, in_channels: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = SubMConv(in_channels, channels, dtype)
        self.conv2_kernel = _kernel(27, channels, channels)
        self.norm2 = nn.LayerNorm(channels, eps=LN_EPS)
        self.proj = (nn.Linear(in_channels, channels, bias=False)
                     if in_channels != channels else None)

    def forward(self, feats: torch.Tensor, ctx) -> torch.Tensor:
        x = self.conv1(feats, ctx)
        x = layer_norm(self.norm2, ctx.conv(x, self.conv2_kernel))
        identity = (feats if self.proj is None
                    else dense(self.proj, feats, self.dtype))
        return ctx.mask(relu(x + identity)).to(self.dtype)


class SparseEncoder(nn.Module):
    def __init__(self, base_channels: int = 16, output_channels: int = 128,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 grid_shape: Sequence[int] = (1504, 1504, 41),
                 max_voxels_per_stage: Sequence[int] = (60000, 60000, 40000,
                                                        20000),
                 layout: str = "gather",
                 max_columns_per_stage: Sequence[int] | None = None,
                 remat_blocks: bool = True,
                 dtype: torch.dtype | str = torch.float32):
        super().__init__()
        if layout not in ("gather", "column"):
            raise ValueError(f"unknown SparseEncoder layout {layout!r}")
        self.layout = layout
        self.max_columns_per_stage = tuple(max_columns_per_stage or
                                           max_voxels_per_stage)
        self.remat_blocks = remat_blocks
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        # the gather layout computes in float32 whatever dtype says
        self.dtype = dt if layout == "column" else torch.float32
        self.output_channels = output_channels
        self.encoder_channels = tuple(tuple(s) for s in encoder_channels)
        self.grid_shape = tuple(int(g) for g in grid_shape)
        self.max_voxels_per_stage = tuple(max_voxels_per_stage)
        self.conv_input = SubMConv(base_channels, base_channels, self.dtype)
        c = base_channels
        for i, stage in enumerate(self.encoder_channels):
            if i > 0:
                self.register_parameter(f"down{i}_kernel",
                                        _kernel(27, c, stage[0]))
                self.add_module(f"down{i}_norm",
                                nn.LayerNorm(stage[0], eps=LN_EPS))
                c = stage[0]
            for j, cj in enumerate(stage):
                self.add_module(f"stage{i}_block{j}",
                                SparseBasicBlock(c, cj, self.dtype))
                c = cj
        self.conv_out_kernel = _kernel(3, c, output_channels)
        self.conv_out_norm = nn.LayerNorm(output_channels, eps=LN_EPS)

    def lattices(self, coords: torch.Tensor, valid: torch.Tensor):
        """Yields ``(grid, s_table)`` per stage: the stage's grid and, from
        stage 1 on, the strided conv's table into the previous stage's grid
        (None at stage 0); then ``("conv_out", conv_out_lattice(...))``. A
        stage's grid (and its dense map) is released once the next one is
        built."""
        grid = sc.build_grid(coords, valid, self.grid_shape)
        yield grid, None
        for i in range(1, len(self.encoder_channels)):
            out_coords, out_valid, ogs = sc.downsample_coords(
                grid, 3, 2, 1, self.max_voxels_per_stage[i])
            s_table = sc.neighbor_table(grid, out_coords, out_valid,
                                        STRIDED_OFFSETS, stride=2)
            grid = sc.build_grid(out_coords, out_valid, ogs)
            yield grid, s_table
        yield "conv_out", conv_out_lattice(grid,
                                           self.max_voxels_per_stage[-1])

    def forward(self, voxel_feats: torch.Tensor, coords: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        """voxel_feats [V0, C]; coords [V0, 3] (x, y, z); valid [V0]. Returns
        the dense BEV map [1, D_out * output_channels, gx / 8, gy / 8]."""
        if self.layout == "column":
            return self._forward_column(voxel_feats, coords, valid)
        stages = self.lattices(coords, valid)
        x = voxel_feats
        for i, stage in enumerate(self.encoder_channels):
            grid, s_table = next(stages)
            if s_table is not None:
                x = sc.sparse_conv_apply(
                    x, s_table, getattr(self, f"down{i}_kernel"), grid.valid)
                x = _norm_act(getattr(self, f"down{i}_norm"), x, grid.valid)
            ctx = GatherCtx(sc.neighbor_table(grid, grid.coords, grid.valid,
                                              OFFSETS_27), grid.valid)
            if i == 0:
                x = self.conv_input(x, ctx)
            for j in range(len(stage)):
                x = getattr(self, f"stage{i}_block{j}")(x, ctx)
        _, (o_coords, o_valid, o_table, ogs, _) = next(stages)
        x = sc.sparse_conv_apply(x, o_table, self.conv_out_kernel, o_valid)
        x = _norm_act(self.conv_out_norm, x, o_valid)
        dense = sc.scatter_to_dense(x, o_coords, o_valid, ogs)
        gx, gy, gz = ogs
        # [gx, gy, gz, C] -> channel c * gz + z, as the JAX package's
        # transpose(0, 1, 3, 2).reshape
        return dense.permute(3, 2, 0, 1).reshape(
            1, self.output_channels * gz, gx, gy)

    def _forward_column(self, voxel_feats, coords, valid):
        budgets = self.max_columns_per_stage
        dt = self.dtype
        grid, col_of = cc.build_columns(coords, valid, self.grid_shape,
                                        budgets[0])
        x = cc.scatter_voxel_feats(voxel_feats.to(dt), coords, col_of,
                                   budgets[0], self.grid_shape[2])
        ctx = ColumnCtx(cc.neighbor_columns(grid), grid.occ)
        x = self.conv_input(x, ctx)
        for i, stage in enumerate(self.encoder_channels):
            if i > 0:
                new_grid, s_nbrs = cc.downsample_columns(grid, budgets[i])
                x = cc.conv3x3x3(x, s_nbrs, getattr(self, f"down{i}_kernel"),
                                 new_grid.occ, stride=2)
                x = torch.where(new_grid.occ[..., None], relu(layer_norm(
                    getattr(self, f"down{i}_norm"), x)), 0.0).to(dt)
                grid = new_grid
                ctx = ColumnCtx(cc.neighbor_columns(grid), grid.occ)
            for j in range(len(stage)):
                block = getattr(self, f"stage{i}_block{j}")
                x = (checkpoint(block, x, ctx, use_reentrant=False)
                     if self.remat_blocks else block(x, ctx))
        x, out_occ = cc.zcompress(x, grid.occ, self.conv_out_kernel)
        x = torch.where(out_occ[..., None],
                        relu(layer_norm(self.conv_out_norm, x)), 0.0)
        gx, gy, gz = grid.grid_shape
        bev = cc.columns_to_bev(x, grid._replace(
            occ=out_occ, grid_shape=(gx, gy, out_occ.shape[1])))
        return bev.permute(2, 0, 1).unsqueeze(0).contiguous()

    @torch.no_grad()
    def voxel_occupancy(self, coords: torch.Tensor, valid: torch.Tensor
                        ) -> list[dict]:
        """Occupied voxels of each downsampled stage's lattice and of
        conv_out's before the budget cuts them, beside the budget; in the
        column layout the occupied columns of every stage against the
        column budgets (host ints; synchronises)."""
        if self.layout == "column":
            counts = cc.column_counts(coords, valid, self.grid_shape,
                                      self.max_columns_per_stage)
            return [{"stage": f"columns {i}", "occupied": n, "budget": b}
                    for i, (n, b) in enumerate(
                        zip(counts, self.max_columns_per_stage))]
        rows, prev = [], None
        for i, (grid, extra) in enumerate(self.lattices(coords, valid)):
            if isinstance(grid, str):
                rows.append({"stage": "conv_out", "occupied": int(extra[4]),
                             "budget": self.max_voxels_per_stage[-1]})
                break
            if prev is not None:
                rows.append({"stage": str(i),
                             "occupied": sc.count_downsampled(prev, 3, 2, 1),
                             "budget": self.max_voxels_per_stage[i]})
            prev = grid
        return rows


def conv_out_lattice(grid: sc.SparseGrid, vmax: int):
    """conv_out's output lattice, z' = (z - k) / 2 for k in 0..2 (kernel
    (3, 1, 1), stride (2, 1, 1), padding 0), deduplicated by a stable sort
    of the keys and cut to ``vmax``. Returns (coords [vmax, 3], valid
    [vmax], table [3, vmax] into ``grid``, grid shape, occupied count before
    the cut as a 0-d tensor)."""
    gx, gy, gz = grid.grid_shape
    ogz = (gz - 3) // 2 + 1
    dev = grid.coords.device
    c = grid.coords.long()
    num_z = c[None, :, 2] - torch.arange(3, device=dev)[:, None]   # [3, V]
    ok = ((num_z % 2 == 0) & (num_z >= 0) & (num_z // 2 < ogz)
          & grid.valid[None])
    cand = torch.stack([c[:, 0].expand_as(num_z), c[:, 1].expand_as(num_z),
                        num_z // 2], -1).reshape(-1, 3)
    cval = ok.reshape(-1)
    big = gx * gy * ogz + 1
    key = cand[:, 0] * (gy * ogz) + cand[:, 1] * ogz + cand[:, 2]
    key = torch.where(cval, key, big)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    first &= skey < big
    slot = torch.cumsum(first, 0) - 1
    oc = torch.zeros((vmax + 1, 3), dtype=torch.long, device=dev)
    oc[torch.where(first, slot, vmax).clamp(max=vmax)] = cand[order]
    oc = oc[:vmax]
    n_occ = first.sum()
    o_valid = torch.arange(vmax, device=dev) < n_occ.clamp(max=vmax)
    # in = (x, y, 2 z + k): a z-triple, so the scaled coords take
    # neighbor_table's slice path
    scaled = oc * torch.tensor([1, 1, 2], device=dev)
    o_table = sc.neighbor_table(grid, scaled, o_valid, CONV_OUT_OFFSETS)
    return oc, o_valid, o_table, (gx, gy, ogz), n_occ
