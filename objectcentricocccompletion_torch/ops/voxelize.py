"""Dynamic voxelization and per-voxel segment reductions, static shapes.

Counterpart of ``objectcentricocccompletion_tpu/ops/voxelize.py``. Points
hash to linearized voxel ids; one stable sort groups them; voxel slots are
the sorted first occurrences, compacted to a fixed ``max_voxels`` buffer.
Every output carries a validity mask, and every index equals the JAX
package's exactly (both sorts are stable).

Scatters that JAX writes with ``mode="drop"`` write here into one spare row
past the end, which is then sliced off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .routes import fed_max, taking


class VoxelizeResult(NamedTuple):
    coords: torch.Tensor       # [V, 3] int64 voxel coords, (x, y, z) order
    voxel_valid: torch.Tensor  # [V] bool
    point2voxel: torch.Tensor  # [N] int64 index into the V buffer (-1 none)
    point_valid: torch.Tensor  # [N] bool (input mask & in range)
    num_voxels: torch.Tensor   # [] int64, may exceed V (extra voxels drop)


def _grid(voxel_size, pc_range, device) -> torch.Tensor:
    """Voxel grid extent, computed in float32 as the JAX package does."""
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=device)
    hi = torch.tensor(pc_range[3:], dtype=torch.float32, device=device)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=device)
    return torch.floor((hi - lo) / vs).long()


def compute_voxel_coords(points: torch.Tensor, voxel_size, pc_range
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer voxel coords + in-range mask for points [..., 3]."""
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=points.device)
    hi = torch.tensor(pc_range[3:], dtype=points.dtype, device=points.device)
    grid = _grid(voxel_size, pc_range, points.device)
    # the JAX package runs this under jit, where XLA turns the division by
    # the constant voxel size into a product with its float32 reciprocal;
    # the same product keeps every voxel coord equal at cell boundaries
    coords = torch.floor((points - lo) * (1.0 / vs)).long()
    in_range = ((points >= lo) & (points < hi)).all(-1)
    coords = torch.minimum(coords.clamp(min=0), grid - 1)
    return coords, in_range


def voxelize(points: torch.Tensor, mask: torch.Tensor, voxel_size, pc_range,
             max_voxels: int) -> VoxelizeResult:
    """points [N, >=3]; mask [N] bool. Static output with V = max_voxels."""
    n = points.shape[0]
    dev = points.device
    coords, in_range = compute_voxel_coords(points[:, :3], voxel_size,
                                            pc_range)
    valid = mask & in_range
    g = _grid(voxel_size, pc_range, dev)
    key = coords[:, 0] * g[1] * g[2] + coords[:, 1] * g[2] + coords[:, 2]
    big = g[0] * g[1] * g[2] + 1
    key = torch.where(valid, key, big)

    order = torch.argsort(key, stable=True)
    skey = key[order]
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    first &= skey < big
    slot_sorted = torch.cumsum(first, 0) - 1
    num_voxels = first.sum()
    slot_sorted = torch.where(skey < big, slot_sorted, -1)

    # voxel coords from first occurrences; slots past the buffer drop
    keep = first & (slot_sorted < max_voxels)
    dst = torch.where(keep, slot_sorted, max_voxels)
    vcoords = torch.zeros((max_voxels + 1, 3), dtype=torch.long, device=dev)
    vcoords[dst] = coords[order]
    vcoords = vcoords[:max_voxels]
    voxel_valid = torch.arange(max_voxels, device=dev) < num_voxels

    # back to input order
    p2v = torch.empty(n, dtype=torch.long, device=dev)
    p2v[order] = torch.where(slot_sorted < max_voxels, slot_sorted, -1)
    p2v = torch.where(valid, p2v, -1)
    return VoxelizeResult(vcoords, voxel_valid, p2v, valid, num_voxels)


def scatter_to_voxels(feats: torch.Tensor, p2v: torch.Tensor,
                      max_voxels: int, mode: str = "max") -> torch.Tensor:
    """Per-voxel reduction of point features [N, C] -> [max_voxels, C].
    Points with ``p2v == -1`` go to a spare row that is sliced away; empty
    voxels give 0. The max is routed (``ops/routes.py``)."""
    seg = torch.where(p2v >= 0, p2v, max_voxels)
    c = feats.shape[1]
    shape = (max_voxels + 1, c)
    if mode == "max":
        out = torch.full(shape, float("-inf"), dtype=feats.dtype,
                         device=feats.device)
        out.scatter_reduce_(0, seg[:, None].expand(-1, c), feats, "amax")
        routes = taking(feats)
        if routes is not None:
            win = routes.take("voxel_max", (feats.detach() == out.detach()[
                seg]) & (p2v >= 0)[:, None])
            if routes.feeding:
                out = fed_max(out, feats, win, lambda t: t.new_zeros(
                    shape).index_add(0, seg, t))
        out = torch.where(torch.isfinite(out), out, 0.0)
    elif mode in ("mean", "avg", "sum"):
        out = torch.zeros(shape, dtype=feats.dtype, device=feats.device)
        out.index_add_(0, seg, feats)
        if mode != "sum":
            cnt = torch.bincount(seg, minlength=max_voxels + 1)
            out = out / cnt.clamp(min=1)[:, None].to(feats.dtype)
    else:
        raise ValueError(mode)
    return out[:max_voxels]


def gather_from_voxels(vfeats: torch.Tensor, p2v: torch.Tensor
                       ) -> torch.Tensor:
    """Broadcast voxel features back to points; dropped points get 0."""
    out = vfeats[p2v.clamp(0, vfeats.shape[0] - 1)]
    return torch.where((p2v >= 0)[:, None], out, 0.0)
