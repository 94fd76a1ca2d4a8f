"""SST (Single-Stride Sparse Transformer): windowed sparse attention over
pillars, ending in a BEV canvas.

Counterpart of the JAX package's ``models/sst.py``. Both window partitions
(regular and shifted) are computed once; each attention layer is a dense
masked multi-head attention over ``[n_windows, capacity, C]`` tokens, run
at two capacities (two-level drop-level batching: sparse windows attend at
``small_capacity``). The attention core is the hand-written kernel of
``ops/window_attention.py`` when ``use_pallas_attention`` is set (the
field keeps the JAX config's name), else its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import voxelize as vx
from ..ops import window as win
from ..ops.window_attention import window_attention, window_attention_plain
from .layers import _gelu_exact, dense, layer_norm
from .vfe import DynamicVFE


@dataclasses.dataclass(frozen=True)
class SSTConfig:
    voxel_size: Sequence[float] = (0.32, 0.32, 6.0)
    pc_range: Sequence[float] = (-74.88, -74.88, -2.0, 74.88, 74.88, 4.0)
    window_shape: Sequence[int] = (12, 12, 1)
    max_voxels: int = 20000
    max_points: int = 160000
    max_windows: int = 3200
    d_model: int = 128
    num_heads: int = 8
    ffn_dim: int = 256
    num_blocks: int = 6
    vfe_channels: Sequence[int] = (64, 128)
    pos_temperature: float = 10000.0
    # attention core: the hand-written kernel (True) or its plain version
    use_pallas_attention: bool = True
    # computation dtype of the transformer, VFE and attention; parameters
    # and LayerNorm statistics stay float32
    compute_dtype: str = "float32"
    # two-level batching: windows with <= small_capacity tokens attend at
    # the small budget; 0 (or >= capacity) disables it
    small_capacity: int = 32
    # window budgets per level (None: small = max_windows, large =
    # max_windows / 4)
    max_small_windows: int | None = None
    max_large_windows: int | None = None
    # point columns: x, y, z and two features (intensity and elongation on
    # Waymo), plus the time lag of multi-sweep frames (6). The JAX package
    # reads it off the input, whose width the port's first Dense fixes
    point_dim: int = 5

    @property
    def small_windows_budget(self) -> int:
        return (self.max_small_windows if self.max_small_windows is not None
                else self.max_windows)

    @property
    def large_windows_budget(self) -> int:
        return (self.max_large_windows if self.max_large_windows is not None
                else max(self.max_windows // 4, 1))

    @property
    def grid_shape(self):
        return tuple(np.round(
            (np.asarray(self.pc_range[3:]) - np.asarray(self.pc_range[:3]))
            / np.asarray(self.voxel_size)).astype(int))

    @property
    def capacity(self):
        w = self.window_shape
        return int(w[0] * w[1] * w[2])


def tiny_sst_config() -> SSTConfig:
    return SSTConfig(voxel_size=(0.8, 0.8, 6.0),
                     pc_range=(-9.6, -9.6, -2, 9.6, 9.6, 4),
                     window_shape=(4, 4, 1), max_voxels=512, max_points=2048,
                     max_windows=64, d_model=32, num_heads=4, ffn_dim=64,
                     num_blocks=2, vfe_channels=(16, 32))


def window_pos_embed(coors_in_win: torch.Tensor, window_shape, d_model: int,
                     temperature: float) -> torch.Tensor:
    """Sine embedding of in-window (x, y) offsets: per axis, sin and cos of
    alternate frequencies interleaved, then x and y concatenated."""
    wx, wy, _ = window_shape
    x = coors_in_win[:, 0].float() - wx / 2
    y = coors_in_win[:, 1].float() - wy / 2
    pos_length = d_model // 2
    # a constant of the config, rounded once from float64 to float32 (within
    # an ulp of the JAX package's float32 power)
    i = np.arange(pos_length)
    inv_freq = torch.tensor(temperature ** (2 * (i // 2) / pos_length),
                            dtype=torch.float32, device=coors_in_win.device)

    def embed(t):
        e = t[:, None] / inv_freq[None, :]
        return torch.stack([torch.sin(e[:, ::2]), torch.cos(e[:, 1::2])],
                           -1).reshape(t.shape[0], -1)

    return torch.cat([embed(x), embed(y)], -1)


class WindowMSALayer(nn.Module):
    """Post-norm encoder layer over windowed tokens: q = k = x + pos,
    masked multi-head attention, exact-GELU FFN, LayerNorms (eps 1e-5)."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int,
                 use_kernel: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernel = use_kernel
        self.dtype = dtype
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn1 = nn.Linear(d_model, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tokens: torch.Tensor, pos: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """tokens/pos [W, T, C]; mask [W, T] True = valid. Returns float32
        (the LayerNorm output), as the JAX layer does."""
        dt = self.dtype or tokens.dtype
        tokens = tokens.to(dt)
        qk = tokens + pos.to(dt)
        q = dense(self.q, qk, dt)
        k = dense(self.k, qk, dt)
        v = dense(self.v, tokens, dt)
        attend = window_attention if self.use_kernel else \
            window_attention_plain
        a = attend(q, k, v, mask, self.num_heads)
        x = layer_norm(self.norm1, tokens + dense(self.out, a, dt))
        f = dense(self.ffn2, _gelu_exact(dense(self.ffn1, x, dt)), dt)
        x = layer_norm(self.norm2, x + f)
        return torch.where(mask[..., None], x, 0.0)


class SST(nn.Module):
    def __init__(self, cfg: SSTConfig):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.compute_dtype)
        self.vfe = DynamicVFE(cfg.point_dim, feat_channels=cfg.vfe_channels,
                              voxel_size=cfg.voxel_size,
                              pc_range=cfg.pc_range, dtype=dt)
        self.input_proj = nn.Linear(cfg.vfe_channels[-1], cfg.d_model)
        self.layers = nn.ModuleList(
            WindowMSALayer(cfg.d_model, cfg.num_heads, cfg.ffn_dim,
                           use_kernel=cfg.use_pallas_attention, dtype=dt)
            for _ in range(cfg.num_blocks) for _ in (0, 1))
        self.dtype = dt

    def partitions(self, vres: vx.VoxelizeResult):
        """Per shift (regular, shifted): the levels as
        ``(partition, window budget, capacity)`` and the windowed position
        embedding of each level."""
        c = self.cfg
        gs = c.grid_shape
        two_level = 0 < c.small_capacity < c.capacity
        parts, pos = [], []
        for s in (False, True):
            p = win.partition(vres.coords, vres.voxel_valid, gs,
                              c.window_shape, s, c.max_windows, c.capacity)
            pe = window_pos_embed(p.coors_in_win, c.window_shape, c.d_model,
                                  c.pos_temperature)
            if two_level:
                ps, pl = win.split_by_occupancy(
                    p, c.max_windows, c.small_capacity,
                    c.small_windows_budget, c.large_windows_budget)
                levels = ((ps, c.small_windows_budget, c.small_capacity),
                          (pl, c.large_windows_budget, c.capacity))
            else:
                levels = ((p, c.max_windows, c.capacity),)
            parts.append(levels)
            pos.append([win.flat_to_window(pe, lp, mw, cap)[0]
                        for lp, mw, cap in levels])
        return parts, pos

    def forward(self, points: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        """points [N, 3+F]; mask [N] -> BEV canvas [GX, GY, d_model]."""
        c = self.cfg
        gx, gy, _ = (int(g) for g in c.grid_shape)
        vres = vx.voxelize(points, mask, c.voxel_size, c.pc_range,
                           c.max_voxels)
        vfeat, _ = self.vfe(points, vres, c.max_voxels)
        x = dense(self.input_proj, vfeat, self.dtype)
        x = torch.where(vres.voxel_valid[:, None], x, 0.0)
        parts, pos = self.partitions(vres)

        for i, layer in enumerate(self.layers):
            s = i % 2
            out_x = x
            for li, (lp, mw, cap) in enumerate(parts[s]):
                tokens, tmask = win.flat_to_window(x, lp, mw, cap)
                tokens = layer(tokens, pos[s][li], tmask)
                out = win.window_to_flat(tokens, lp)
                out_x = torch.where((lp.win_of_voxel >= 0)[:, None], out,
                                    out_x)
            # voxels dropped by every level keep their previous feature
            x = out_x

        # BEV canvas; invalid voxels go to a spare row past the end
        cx = torch.where(vres.voxel_valid, vres.coords[:, 0], gx)
        cy = torch.where(vres.voxel_valid, vres.coords[:, 1], 0)
        canvas = x.new_zeros((gx + 1, gy, c.d_model))
        canvas[cx, cy] = torch.where(vres.voxel_valid[:, None], x, 0.0)
        return canvas[:gx]
