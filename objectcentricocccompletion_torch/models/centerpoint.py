"""DynamicCenterPoint (W2), the dense single-frame LiDAR detector
(counterpart of the JAX package's ``models/centerpoint.py``): dynamic
voxelization -> DynamicVFE -> sparse 3D encoder -> dense BEV -> SECOND +
FPN -> CenterHead. Configured after the reference's
``configs/centerpoint/cp_voxel_full_6e_car_occ.py``.

One frame's padded point buffer per call. float32 end to end but for the
encoder's column layout (``encoder_layout="column"``), whose activations
are in ``encoder_dtype`` (bf16 by default; the convolutions sum in float32)
and whose residual blocks are recomputed in the backward
(``encoder_remat``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import voxelize as vx
from ..utils.device import resolve_device
from . import centerpoint_head as cph
from .layers import he_normal_, init_flax_like_
from .second import SECOND, SECONDFPN
from .sparse_encoder import SparseEncoder
from .vfe import DynamicVFE


@dataclasses.dataclass(frozen=True)
class CenterPointConfig:
    voxel_size: Sequence[float] = (0.1, 0.1, 0.15)
    pc_range: Sequence[float] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0)
    max_voxels: int = 60000
    max_points: int = 160000
    vfe_channels: Sequence[int] = (16, 16)
    num_classes: int = 1
    out_size_factor: int = 8
    encoder_layout: str = "gather"   # 'gather' | 'column' (same parameters)
    # the column layout's options (its activation dtype and remat); the
    # gather layout computes in float32 whatever they say, in both packages
    encoder_dtype: str = "bfloat16"
    encoder_remat: bool = True
    # point columns: x, y, z and two features (intensity and elongation on
    # Waymo), plus the time lag of multi-sweep frames (6). The JAX package
    # reads it off the input, whose width the port's first Dense fixes
    point_dim: int = 5

    @property
    def grid_shape(self) -> tuple:
        g = np.round((np.asarray(self.pc_range[3:])
                      - np.asarray(self.pc_range[:3]))
                     / np.asarray(self.voxel_size)).astype(int)
        return tuple(int(x) for x in g)


def tiny_centerpoint_config() -> CenterPointConfig:
    return CenterPointConfig(
        voxel_size=(0.4, 0.4, 0.3), pc_range=(-6.4, -6.4, -1.2, 6.4, 6.4,
                                              8.4),
        max_voxels=2048, max_points=4096, vfe_channels=(8, 8))


class DynamicCenterPoint(nn.Module):
    """``DynamicCenterPoint(cfg, device, generator)``: points carry
    ``cfg.point_dim`` columns (x, y, z and two features, as the frame
    datasets and ``synth_frame`` give them; a time lag with sweeps). Built on the CPU, its weights drawn from
    ``generator`` as flax initialises them when one is given, then moved to
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, cfg: CenterPointConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = c = cfg
        self.vfe = DynamicVFE(c.point_dim, feat_channels=c.vfe_channels,
                              voxel_size=c.voxel_size, pc_range=c.pc_range)
        scale = max(c.vfe_channels[-1] // 16, 1)
        out_c = 8 * scale * 16
        self.encoder = SparseEncoder(
            base_channels=c.vfe_channels[-1], output_channels=out_c,
            encoder_channels=tuple(
                tuple(x * scale for x in s)
                for s in ((16, 16, 32), (32, 32, 64), (64, 64, 128),
                          (128, 128))),
            grid_shape=c.grid_shape,
            max_voxels_per_stage=(c.max_voxels, c.max_voxels,
                                  c.max_voxels // 2, c.max_voxels // 4),
            max_columns_per_stage=(c.max_voxels, c.max_voxels // 2,
                                   c.max_voxels // 4, c.max_voxels // 8),
            layout=c.encoder_layout, dtype=c.encoder_dtype,
            remat_blocks=c.encoder_remat)
        # z after three stride-2 downsamples and conv_out's (3, 1, 1) / 2
        gz = c.grid_shape[2]
        for _ in range(3):
            gz = (gz - 1) // 2 + 1
        self.backbone = SECOND(out_c * ((gz - 3) // 2 + 1))
        self.neck = SECONDFPN()
        self.head = cph.CenterHead(512, num_classes=c.num_classes)
        if generator is not None:
            init_flax_like_(self, generator)
            for m in self.modules():
                if isinstance(m, nn.ConvTranspose2d):
                    # flax's lecun normal, fan_in = kh * kw * in
                    w = torch.empty(m.weight.shape)
                    std = (1.0 / (w.shape[0] * w[0, 0].numel())) ** 0.5
                    std /= 0.87962566103423978
                    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    with torch.no_grad():
                        m.weight.copy_(w)
            for name, p in self.encoder.named_parameters():
                if name.endswith("kernel"):
                    he_normal_(p, generator)
            self.head.task0.reset_heatmap_bias()
        self.to(dev)

    def voxelize(self, points: torch.Tensor, mask: torch.Tensor
                 ) -> vx.VoxelizeResult:
        c = self.cfg
        return vx.voxelize(points, mask, c.voxel_size, c.pc_range,
                           c.max_voxels)

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> dict:
        """points [N, 3+F] float32, mask [N] bool -> the head's maps, name
        -> [H, W, c] float32 (heatmap, reg, height, dim, rot, vel)."""
        vres = self.voxelize(points, mask)
        vfeat, _ = self.vfe(points, vres, self.cfg.max_voxels)
        bev = self.encoder(vfeat, vres.coords, vres.voxel_valid)
        return self.head(self.neck(self.backbone(bev)))

    def loss(self, points, mask, gt_boxes, gt_labels, gt_valid) -> dict:
        """One frame's losses -> dict of float32 scalars ``loss_heatmap``,
        ``loss_bbox`` and ``loss``."""
        c = self.cfg
        return cph.center_head_loss(self(points, mask), gt_boxes, gt_labels,
                                    gt_valid, c.voxel_size, c.pc_range,
                                    c.out_size_factor)

    def predict(self, points, mask, max_out: int = 500):
        """-> (boxes [K, 9], scores [K], labels [K], valid [K])."""
        c = self.cfg
        return cph.decode(self(points, mask), c.voxel_size, c.pc_range,
                          c.out_size_factor, max_out)

    @torch.no_grad()
    def voxel_occupancy(self, points: torch.Tensor, mask: torch.Tensor
                        ) -> list[dict]:
        """Occupied voxels at each stage before its budget cuts it, beside
        the budget: the voxelized input, then the encoder's three downsampled
        stages and conv_out (gather layout) or its columns per stage (column
        layout) (host ints). Both packages drop what exceeds a budget
        silently."""
        vres = self.voxelize(points, mask)
        return ([{"stage": "voxelize", "occupied": int(vres.num_voxels),
                  "budget": self.cfg.max_voxels}]
                + self.encoder.voxel_occupancy(vres.coords,
                                               vres.voxel_valid))
