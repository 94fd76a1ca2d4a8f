"""Synthetic LiDAR frames at production point budgets.

Counterpart of ``benchmarks/bench_detectors.py::synth_frame`` in numpy only:
the same seed gives the same arrays. Uniform points over the range with
about 10% of them clustered into 64 car-sized blobs, which gives realistic
voxel and window occupancy.
"""
from __future__ import annotations

import numpy as np


def synth_frame(max_points: int, pc_range, num_real: int = 150000,
                feat_dim: int = 2, seed: int = 0):
    """Returns ``(points [max_points, 3+feat_dim] f32, mask [max_points]
    bool, boxes [32, 7] f32, labels [32] int32, valid [32] bool)``."""
    rng = np.random.RandomState(seed)
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:])
    n = min(num_real, max_points)
    pts = rng.uniform(lo, hi, (n, 3))
    nb = n // 10
    centers = rng.uniform(lo + 5, hi - 5, (64, 3))
    blob = centers[rng.randint(64, size=nb)] + rng.normal(0, 1.2, (nb, 3))
    pts[:nb] = np.clip(blob, lo, hi - 1e-3)
    feats = rng.rand(n, feat_dim)
    points = np.zeros((max_points, 3 + feat_dim), np.float32)
    points[:n] = np.concatenate([pts, feats], -1)
    mask = np.arange(max_points) < n
    boxes = np.concatenate([
        centers[:32], np.abs(rng.normal([2, 4.5, 1.7], 0.1, (32, 3))),
        rng.uniform(-np.pi, np.pi, (32, 1))], -1).astype(np.float32)
    return (points, mask, boxes, np.zeros((32,), np.int32),
            np.ones((32,), bool))
