"""Incremental (voxel-difference) point selection for FSD++ (counterpart of
the JAX package's ``ops/incremental.py``): keep the current points whose
voxel no previous point occupies.

Both clouds hash to int32 voxel keys on a ``floor(extent / voxel) + 1``
grid (``floor``, where FSD's grids round); the previous keys are sorted and
each current key is looked up with a left-side ``searchsorted``.
"""
from __future__ import annotations

import numpy as np
import torch


def _hash(points: torch.Tensor, mask: torch.Tensor, voxel_size, pc_range
          ) -> torch.Tensor:
    """int32 voxel key of each point, the sentinel ``grid.prod()`` where
    ``mask`` is False."""
    grid = np.floor((np.asarray(pc_range[3:]) - np.asarray(pc_range[:3]))
                    / np.asarray(voxel_size)).astype(np.int64) + 1
    assert int(grid.prod()) < 2**31, "grid too large for int32 keys"
    dev = points.device
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=dev)
    # the JAX package runs this under jit, where XLA turns the division by
    # the constant voxel size into a product with its float32 reciprocal;
    # the same product keeps every key equal on cell boundaries
    c = torch.floor((points[:, :3] - lo) * (1.0 / vs)).to(torch.int32)
    c = torch.minimum(c.clamp(min=0), torch.tensor(
        grid - 1, dtype=torch.int32, device=dev))
    key = (c[:, 0] * int(grid[1] * grid[2]) + c[:, 1] * int(grid[2])
           + c[:, 2])
    return torch.where(mask, key, int(grid.prod()))


def incremental_points_mask(prev_points: torch.Tensor,
                            prev_mask: torch.Tensor,
                            cur_points: torch.Tensor, cur_mask: torch.Tensor,
                            voxel_size, pc_range) -> torch.Tensor:
    """True for the current points in voxels that no valid previous point
    occupies (the reference's ``find_delta_points_by_voxelization``)."""
    pk = _hash(prev_points, prev_mask, voxel_size, pc_range)
    ck = _hash(cur_points, cur_mask, voxel_size, pc_range)
    sorted_prev = torch.sort(pk).values
    pos = torch.searchsorted(sorted_prev, ck).clamp(
        0, sorted_prev.shape[0] - 1)
    seen = sorted_prev[pos] == ck
    return cur_mask & ~seen
