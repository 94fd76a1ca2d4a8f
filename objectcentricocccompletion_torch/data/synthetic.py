"""Synthetic inputs at production budgets, drawn in numpy: the same seed
gives the same arrays as the JAX package's generators.

- ``synth_frame`` (counterpart of ``benchmarks/bench_detectors.py::
  synth_frame``): a LiDAR frame of uniform points over the range with about
  10% of them clustered into 64 car-sized blobs, which gives realistic voxel
  and window occupancy.
- ``synthetic_batch`` (counterpart of ``data/synthetic.py::
  synthetic_batch``): a batch of tracklets, each a box moving along a
  smooth trajectory with points on its surface, proposals near the GT
  boxes and occupancy samples in the GT volume.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.ococcnet_config import OcOccNetConfig
from .tracklet import TrackletBatch


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


def synthetic_batch(cfg: OcOccNetConfig, batch_size: int | None = None,
                    seed: int = 0) -> TrackletBatch:
    """A ``TrackletBatch`` of CPU tensors: B tracklets of ``cfg.reg_len``
    frames, ``cfg.max_points_per_frame`` point slots per frame and
    ``cfg.num_occ_samples`` occupancy samples. A frame's valid point count
    falls with the inverse square of its range (every slot inside 10 m,
    at least 16)."""
    rng = np.random.RandomState(seed)
    B = batch_size if batch_size is not None else cfg.batch_size
    L, P, K = cfg.reg_len, cfg.max_points_per_frame, cfg.num_occ_samples

    # trajectory: near-linear motion with noise
    start = rng.uniform(-45, 45, (B, 1, 2))
    vel = rng.uniform(-1.0, 1.0, (B, 1, 2))
    t = np.arange(L)[None, :, None]
    ctr_xy = start + vel * t + rng.normal(0, 0.05, (B, L, 2))
    ctr_z = rng.uniform(-1.5, 0.5, (B, 1, 1)) * np.ones((1, L, 1))
    size = np.abs(rng.normal([4.5, 2.0, 1.7], 0.4, (B, 1, 3))) * np.ones(
        (1, L, 1))
    yaw = (np.arctan2(vel[..., 1], vel[..., 0])
           + rng.normal(0, 0.05, (B, L)))[..., None]
    gt = np.concatenate([ctr_xy, ctr_z, size, yaw], -1).astype(np.float32)

    # proposals: GT + noise
    rois = gt + np.concatenate([
        rng.uniform(-0.15, 0.15, (B, L, 3)),
        rng.uniform(-0.1, 0.1, (B, L, 3)),
        rng.uniform(-0.1, 0.1, (B, L, 1))], -1).astype(np.float32)

    # points: on-surface samples in the box frame, pushed to ego
    u = rng.uniform(-0.5, 0.5, (B, L, P, 3))
    face = rng.randint(0, 3, (B, L, P))
    sgn = rng.choice([-0.5, 0.5], (B, L, P))
    for a in range(3):
        m = face == a
        u[..., a][m] = sgn[m]
    local = u * size[:, :, None, :]
    c, s = np.cos(yaw)[..., None], np.sin(yaw)[..., None]
    ex = local[..., 0:1] * c - local[..., 1:2] * s
    ey = local[..., 0:1] * s + local[..., 1:2] * c
    xyz = np.concatenate([ex, ey, local[..., 2:3]], -1)
    xyz[..., :2] += ctr_xy[:, :, None]
    xyz[..., 2:] += ctr_z[:, :, None] + size[:, :, None, 2:] / 2

    feats = np.concatenate([
        rng.rand(B, L, P, 2),                      # intensity, elongation
        np.broadcast_to(yaw[:, :, None] / np.pi, (B, L, P, 1)),
        np.broadcast_to(size[:, :, None] / 10.0, (B, L, P, 3)),
        np.broadcast_to(rng.rand(B, L, 1, 1), (B, L, P, 1)),  # det score
    ], -1)
    points = np.concatenate([xyz, feats], -1).astype(np.float32)
    # LiDAR returns fall with the inverse square of the range
    dist = np.linalg.norm(ctr_xy, axis=-1)                      # [B, L]
    frac = np.clip((10.0 / np.maximum(dist, 1.0)) ** 2, 0.0, 1.0)
    npts = np.clip((P * frac).astype(np.int64), min(16, P), P)
    mask = np.arange(P)[None, None] < npts[..., None]

    occ_pts = (rng.uniform(-0.5, 0.5, (B, K, 3))
               * size[:, 0][:, None]).astype(np.float32)
    occ_lab = (rng.rand(B, K) < 0.4).astype(np.int32)

    return TrackletBatch(
        points=torch.from_numpy(points),
        points_mask=torch.from_numpy(mask),
        rois=torch.from_numpy(rois),
        roi_scores=torch.from_numpy(
            rng.rand(B, L).astype(np.float32) * 0.5 + 0.5),
        frame_inds=torch.from_numpy(
            np.tile(np.arange(L, dtype=np.int32), (B, 1))),
        gt_boxes=torch.from_numpy(gt),
        gt_valid=torch.from_numpy(rng.rand(B, L) < 0.95),
        occ_points=torch.from_numpy(occ_pts),
        occ_labels=torch.from_numpy(occ_lab),
        occ_mask=torch.from_numpy(np.ones((B, K), bool)),
        occ_score=torch.from_numpy(
            rng.uniform(0.5, 1.0, (B,)).astype(np.float32)),
    )
