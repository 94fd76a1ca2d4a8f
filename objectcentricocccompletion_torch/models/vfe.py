"""Dynamic voxel feature encoder (counterpart of the JAX package's
``models/vfe.py::DynamicVFE``).

Per-point decoration (offset to the voxel's point mean, offset to the voxel
centre), then Linear -> LayerNorm -> ReLU layers with a per-voxel max and a
broadcast-concat between layers; the voxel feature is the last layer's
per-voxel max. The Linear layers run in the computation dtype; decoration
and LayerNorm statistics stay float32, the variance in flax's one pass
(``layer_norm_one_pass``), which keeps the first layer's gradient within
the JAX package's.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import voxelize as vx
from ..ops.routes import relu
from .layers import LN_EPS, dense, layer_norm_one_pass


class DynamicVFE(nn.Module):
    def __init__(self, in_channels: int,
                 feat_channels: Sequence[int] = (64, 64),
                 voxel_size: Sequence[float] = (0.1, 0.1, 0.15),
                 pc_range: Sequence[float] = (-74.88, -74.88, -2, 74.88,
                                              74.88, 4),
                 mode: str = "max", dtype: torch.dtype | None = None):
        """``in_channels`` counts the raw point features (3 + F); the
        cluster- and voxel-centre offsets add 6."""
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.mode = mode
        self.dtype = dtype
        chans = [in_channels + 6]
        for i, c in enumerate(feat_channels):
            fin = chans[-1] if i == 0 else 2 * chans[-1]
            self.add_module(f"vfe_{i}", nn.Linear(fin, c, bias=False))
            self.add_module(f"norm_{i}", nn.LayerNorm(c, eps=LN_EPS))
            chans.append(c)
        self.num_layers = len(feat_channels)

    def forward(self, points: torch.Tensor, vres: vx.VoxelizeResult,
                max_voxels: int) -> tuple[torch.Tensor, torch.Tensor]:
        """points [N, 3+F]; vres from ``ops.voxelize``. Returns voxel feats
        [V, C] and the last layer's per-point features [N, C]."""
        p2v = vres.point2voxel
        xyz = points[:, :3]
        vmean = vx.scatter_to_voxels(xyz, p2v, max_voxels, "mean")
        vs = torch.tensor(self.voxel_size, dtype=points.dtype,
                          device=points.device)
        lo = torch.tensor(self.pc_range[:3], dtype=points.dtype,
                          device=points.device)
        centers = (vres.coords.to(points.dtype) + 0.5) * vs + lo
        x = torch.cat([points, xyz - vx.gather_from_voxels(vmean, p2v),
                       xyz - vx.gather_from_voxels(centers, p2v)], -1)
        pvalid = vres.point_valid[:, None]
        point_feats = torch.where(pvalid, x, 0.0)
        for i in range(self.num_layers):
            h = dense(getattr(self, f"vfe_{i}"), point_feats, self.dtype)
            h = relu(layer_norm_one_pass(getattr(self, f"norm_{i}"), h))
            point_feats = torch.where(pvalid, h, 0.0)
            vfeat = vx.scatter_to_voxels(point_feats, p2v, max_voxels,
                                         self.mode)
            if i != self.num_layers - 1:
                point_feats = torch.cat(
                    [point_feats, vx.gather_from_voxels(vfeat, p2v)], -1)
        return vfeat, point_feats
