"""TrackletSegmentor, the whole-tracklet sparse-UNet point feature
extractor of CTRL (counterpart of the JAX package's
``models/tracklet_segmentor.py``; the reference's ``TrackletSegmentor``,
configured in ``configs/ctrl/ctrl_veh_24e.py:14-80``).

A tracklet's points of every frame, in one shared frame, are voxelized
together: the intensity and elongation columns go through tanh, the frame
index over ``timestamp_normalizer`` is appended as a column, then
``DynamicVFE`` and the submanifold ``SparseUNet`` of FSD run on the voxels,
and each point gets its VFE feature and its voxel's UNet feature. One call
is one tracklet ``[N, 3+F]`` with a mask; OcOccNet loops over the batch.
Float32 whatever the model's compute dtype, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import voxelize as vx
from .fsd import SparseUNet
from .vfe import DynamicVFE


@dataclasses.dataclass(frozen=True)
class TrackletSegmentorConfig:
    voxel_size: Sequence[float] = (0.25, 0.25, 0.25)   # seg_voxel_size
    pc_range: Sequence[float] = (-100.0, -100.0, -10.0, 100.0, 100.0, 10.0)
    max_voxels: int = 16384
    vfe_channels: Sequence[int] = (64, 64)
    unet_channels: Sequence[int] = (64, 64, 128)
    tanh_dims: Sequence[int] = (3, 4)      # point columns, counted from 0
    timestamp_normalizer: float = 100.0


def tiny_segmentor_config() -> TrackletSegmentorConfig:
    return TrackletSegmentorConfig(
        voxel_size=(1.0, 1.0, 1.0), max_voxels=512,
        vfe_channels=(16, 16), unet_channels=(16, 16))


def segmentor_config(mode: str) -> TrackletSegmentorConfig:
    """The config of OcOccNet's ``use_segmentor``: ``tiny`` or ``full``."""
    if mode == "tiny":
        return tiny_segmentor_config()
    if mode == "full":
        return TrackletSegmentorConfig()
    raise ValueError(f"use_segmentor {mode!r}; one of 'tiny', 'full'")


class TrackletSegmentor(nn.Module):
    def __init__(self, cfg: TrackletSegmentorConfig, point_dim: int):
        """``point_dim``: the points' columns (3 + F); the timestamp column
        adds one."""
        super().__init__()
        self.cfg = c = cfg
        self.vfe = DynamicVFE(point_dim + 1, feat_channels=c.vfe_channels,
                              voxel_size=c.voxel_size, pc_range=c.pc_range,
                              dtype=torch.float32)
        self.unet = SparseUNet(c.vfe_channels[-1], c.unet_channels,
                               c.max_voxels)
        extent = np.asarray(c.pc_range[3:]) - np.asarray(c.pc_range[:3])
        self.grid = tuple(int(g) for g in np.maximum(
            np.floor(extent / np.asarray(c.voxel_size)), 1))
        self.tanh_cols = [d - 3 for d in c.tanh_dims if d - 3 < point_dim - 3]

    @property
    def out_channels(self) -> int:
        """Per point: the VFE feature and the gathered UNet feature."""
        return self.cfg.vfe_channels[-1] + self.cfg.unet_channels[0]

    def forward(self, points: torch.Tensor, frame_inds: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """points [N, 3+F], frame_inds [N] int, mask [N] -> features
        [N, out_channels], 0 on masked rows."""
        c = self.cfg
        rest = points[:, 3:]
        if self.tanh_cols:
            cols = torch.zeros(rest.shape[-1], dtype=torch.bool,
                               device=points.device)
            cols[self.tanh_cols] = True
            rest = torch.where(cols, torch.tanh(rest), rest)
        ts = (frame_inds.to(points.dtype) / c.timestamp_normalizer)[:, None]
        pts = torch.cat([points[:, :3], rest, ts], -1)
        vres = vx.voxelize(pts, mask, c.voxel_size, c.pc_range, c.max_voxels)
        vfeat, pfeat = self.vfe(pts, vres, c.max_voxels)
        vout = self.unet(vfeat, vres.coords, vres.voxel_valid, self.grid)
        out = torch.cat([pfeat, vx.gather_from_voxels(vout,
                                                      vres.point2voxel)], -1)
        return torch.where(mask[:, None], out, 0.0)

    @torch.no_grad()
    def voxel_count(self, points: torch.Tensor, mask: torch.Tensor) -> int:
        """Occupied voxels of one tracklet before the ``max_voxels`` cut
        (a host int; synchronises)."""
        c = self.cfg
        return int(vx.voxelize(points, mask, c.voxel_size, c.pc_range,
                               c.max_voxels).num_voxels)
