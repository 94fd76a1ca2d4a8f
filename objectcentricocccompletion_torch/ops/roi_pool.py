"""Dense tracklet RoI point pooling (counterpart of the JAX package's
``ops/roi_pool.py``).

Each frame's points pool into that frame's single RoI, so the ragged
point-to-RoI gather of the reference's CUDA pool becomes a dense masked
layout ``[B, L, P]``. Per point: box-local coords (3), distances to the six
faces of the original box (6), whether the point lies only in the
``extra_wlh`` margin (1), and the offset from the RoI's bottom centre (3).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import boxes as box_ops


class RoiPoolInfo(NamedTuple):
    mask: torch.Tensor             # [B, L, P] pooled-point validity
    local_xyz: torch.Tensor        # [B, L, P, 3]
    boundary_offset: torch.Tensor  # [B, L, P, 6]
    is_in_margin: torch.Tensor     # [B, L, P]
    rel_xyz: torch.Tensor          # [B, L, P, 3]


def roi_pool(points_xyz: torch.Tensor, points_mask: torch.Tensor,
             rois: torch.Tensor, extra_wlh=(0.5, 0.5, 0.5)) -> RoiPoolInfo:
    """points_xyz [B, L, P, 3], points_mask [B, L, P], rois [B, L, 7];
    ``extra_wlh`` (3 values, or a tensor of them on the points' device)
    enlarges each size (in total) for the pooling."""
    local = box_ops.box_local_coords(points_xyz, rois)
    half = 0.5 * rois[..., None, 3:6]
    extra = torch.as_tensor(extra_wlh, dtype=points_xyz.dtype,
                            device=points_xyz.device)
    half_ext = half + 0.5 * extra
    inside_ext = (local.abs() <= half_ext).all(-1)
    inside_orig = (local.abs() <= half).all(-1)
    mask = points_mask & inside_ext
    # distances to the 6 original faces: (+x, +y, +z, -x, -y, -z)
    boundary = torch.cat([half - local, local + half], -1)
    in_margin = (inside_ext & ~inside_orig).to(points_xyz.dtype)
    rel = points_xyz - rois[..., None, 0:3]
    return RoiPoolInfo(mask, local, boundary, in_margin, rel)


def _snap(local_xyz: torch.Tensor, min_bound: torch.Tensor,
          voxel_size: float) -> torch.Tensor:
    # the JAX package runs this under jit, where XLA turns the division by
    # the constant voxel size into a product with its float32 reciprocal;
    # the same product keeps every cell equal at cell boundaries
    inv = float(np.float32(1.0) / np.float32(voxel_size))
    coors = torch.floor((local_xyz - min_bound) * inv)
    return coors * voxel_size + min_bound + 0.5 * voxel_size


def quantize_to_voxel_centers(local_xyz: torch.Tensor,
                              roi_sizes: torch.Tensor,
                              voxel_size: float) -> torch.Tensor:
    """Snap box-local points ``[..., P, 3]`` to the centres of a voxel grid
    spanning ``[-size/2, size/2]`` of ``roi_sizes [..., 3]``."""
    return _snap(local_xyz, -0.5 * roi_sizes[..., None, :], voxel_size)


def quantize_to_voxel_centers_aligned(local_xyz: torch.Tensor,
                                      roi_sizes: torch.Tensor,
                                      voxel_size: float) -> torch.Tensor:
    """The same with ``roi_sizes`` already expanded per point (packed
    layout: both ``[B, N, 3]``)."""
    return _snap(local_xyz, -0.5 * roi_sizes, voxel_size)
