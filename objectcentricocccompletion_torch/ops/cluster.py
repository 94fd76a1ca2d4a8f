"""Connected-component clustering over a sparse voxel grid (counterpart of
the JAX package's ``ops/cluster.py``), on the device.

Every active voxel repeatedly adopts the smallest label among its linked
neighbours, then jumps to its label's label (pointer jumping). The number
of iterations is fixed at 16, as in the JAX package: stopping at
convergence, or after another count, gives other labels wherever 16 do not
converge. The neighbour tables come from ``ops/sparse_conv.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import sparse_conv as sc

NUM_ITERS = 16


def _propagate(labels: torch.Tensor, table: torch.Tensor,
               linked: torch.Tensor, num_iters: int) -> torch.Tensor:
    """``num_iters`` rounds of min-label propagation along ``linked``
    entries of ``table`` [K, V], each followed by one pointer jump; labels
    equal to V (invalid voxels) stay V."""
    v = labels.shape[0]
    safe = table.clamp(0, v - 1)
    for _ in range(num_iters):
        neigh = torch.where(linked, labels[safe], v)
        labels = torch.minimum(labels, neigh.amin(0))
        labels = torch.where(labels < v, labels[labels.clamp(0, v - 1)],
                             labels)
    return labels


def _initial_labels(valid: torch.Tensor) -> torch.Tensor:
    v = valid.shape[0]
    return torch.where(valid, torch.arange(v, device=valid.device), v)


def connected_components(coords: torch.Tensor, valid: torch.Tensor,
                         grid_shape, connect_radius: int = 1,
                         num_iters: int = NUM_ITERS) -> torch.Tensor:
    """coords [V, 3] active voxels -> [V] int64 component labels (equal
    label = same component; -1 for invalid voxels). Voxels link within a
    ``(2 r + 1)^3`` cube."""
    grid = sc.build_grid(coords, valid, grid_shape)
    r = connect_radius
    offs = np.stack(np.meshgrid(*([np.arange(-r, r + 1)] * 3),
                                indexing="ij"), -1).reshape(-1, 3)
    offs = offs[np.any(offs != 0, axis=1)]
    table = sc.neighbor_table(grid, coords, valid, offs)    # [K, V]
    labels = _propagate(_initial_labels(valid), table, table >= 0,
                        num_iters)
    return torch.where(valid, labels, -1)


def connected_components_dist(coords: torch.Tensor, valid: torch.Tensor,
                              grid_shape, centers: torch.Tensor,
                              connect_dist: float, window_radius: int = 2,
                              num_iters: int = NUM_ITERS) -> torch.Tensor:
    """Distance-constrained components: two voxels of a ``(2 r + 1)^2``
    xy window link only where their mean centers ``centers`` [V, 3] lie
    closer than ``connect_dist`` in the xy-plane. Returns [V] labels (-1
    for invalid voxels)."""
    v = coords.shape[0]
    grid = sc.build_grid(coords, valid, grid_shape)
    r = window_radius
    offs = np.stack(np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                                np.arange(1), indexing="ij"),
                    -1).reshape(-1, 3)
    offs = offs[np.any(offs != 0, axis=1)]
    table = sc.neighbor_table(grid, coords, valid, offs)    # [K, V]
    safe = table.clamp(0, v - 1)
    d2 = ((centers[safe][..., :2] - centers[None, :, :2]) ** 2).sum(-1)
    linked = (table >= 0) & (d2 < connect_dist ** 2)
    labels = _propagate(_initial_labels(valid), table, linked, num_iters)
    return torch.where(valid, labels, -1)


def compact_labels(labels: torch.Tensor, max_clusters: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Relabel component ids to ``[0, C)`` in the order of the ids (a
    stable sort); ids past ``max_clusters`` and -1 become -1. Returns
    (labels [V], number of clusters kept as a 0-d tensor)."""
    v = labels.shape[0]
    valid = labels >= 0
    big = torch.iinfo(torch.int32).max
    key = torch.where(valid, labels, big)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    sval = valid[order]
    first = torch.ones_like(sval)
    first[1:] = skey[1:] != skey[:-1]
    first &= sval
    slot = torch.cumsum(first, 0) - 1
    num = first.sum()
    out = torch.empty(v, dtype=torch.long, device=labels.device)
    out[order] = torch.where(sval, slot, -1)
    out = torch.where(out < max_clusters, out, -1)
    return torch.where(valid, out, -1), num.clamp(max=max_clusters)
