"""Test-time occupancy IoU (counterpart of the JAX package's
``evalx/occ_iou.py``).

Per GT-matched frame: decode occupancy at every *known* GT voxel centre
(occupied or free), with the queries moved from the GT box's frame into
the predicted RoI's; predictions outside the predicted box count as free;
IoU of predicted-occupied against GT-occupied. Aggregates: overall IoU
(global sum), mIoU over tracklets, mIoU over boxes, and box IoU binned by
GT volume (<30 / 30-150 / >=150 m^3).

The query buffer is padded to a fixed size with its valid queries first
(``load_full_occ_queries``). Padded queries count in neither sum, so
``occ_iou_per_frame`` decodes only up to the last valid one, in chunks of
16 frames (one decode of 256 frames x 16,384 queries would hold
``[256, 16384, 1024]`` decoder activations). The host-side pieces
(``dense_voxel_centers``, ``load_full_occ_queries``, the accumulator and
the point-aggregation baseline) are numpy copies of the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.ococcnet import gt_occ_to_roi_frame

DECODE_CHUNK = 16


def occ_iou_per_frame(decode_fn, shape_latent: torch.Tensor,
                      rois: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_valid: torch.Tensor, occ_points: torch.Tensor,
                      occ_labels: torch.Tensor, occ_mask: torch.Tensor,
                      pos_thresh: float = 0.5
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame occupancy intersection and union of one tracklet.

    ``decode_fn(latent [l, D], queries [l, K, 3]) -> logits [l, K]``;
    ``shape_latent`` [L, D], ``rois`` / ``gt_boxes`` [L, 7], ``gt_valid``
    [L]; ``occ_points`` [K, 3] known voxel centres in the GT box's frame,
    ``occ_labels`` [K] (1 occupied, 0 free), ``occ_mask`` [K]. Returns
    ``(inter [L], union [L])`` int64, zero where the GT is invalid."""
    with torch.no_grad():
        valid_idx = torch.nonzero(occ_mask)
        k = int(valid_idx.max()) + 1 if len(valid_idx) else 0
        L = shape_latent.shape[0]
        if k == 0:
            zero = torch.zeros(L, dtype=torch.int64, device=rois.device)
            return zero, zero.clone()
        queries = gt_occ_to_roi_frame(occ_points[None, :k], gt_boxes[None],
                                      rois[None])[0]           # [L, k, 3]
        gt_occ = (occ_labels[:k] == 1) & occ_mask[:k]
        inters, unions = [], []
        for beg in range(0, L, DECODE_CHUNK):
            sl = slice(beg, beg + DECODE_CHUNK)
            q = queries[sl]
            pred = torch.sigmoid(decode_fn(shape_latent[sl], q)) > pos_thresh
            half = 0.5 * rois[sl, None, 3:6]
            pred &= (q.abs() <= half).all(-1)                # outside: free
            valid = occ_mask[None, :k] & gt_valid[sl, None]
            inters.append(((pred & gt_occ) & valid).sum(-1))
            unions.append(((pred | gt_occ) & valid).sum(-1))
        return torch.cat(inters), torch.cat(unions)


@dataclass
class OccIoUAccumulator:
    total_inter: float = 0.0
    total_union: float = 0.0
    track_ious: list = field(default_factory=list)
    box_ious: list = field(default_factory=list)
    box_volumes: list = field(default_factory=list)

    def add_tracklet(self, inter: np.ndarray, union: np.ndarray,
                     gt_volumes: np.ndarray, valid: np.ndarray):
        inter = np.asarray(inter)[np.asarray(valid)]
        union = np.asarray(union)[np.asarray(valid)]
        gt_volumes = np.asarray(gt_volumes)[np.asarray(valid)]
        keep = union > 0
        if not keep.any():
            return
        inter, union, gt_volumes = inter[keep], union[keep], gt_volumes[keep]
        self.total_inter += inter.sum()
        self.total_union += union.sum()
        self.track_ious.append(inter.sum() / union.sum())
        self.box_ious.extend((inter / union).tolist())
        self.box_volumes.extend(gt_volumes.tolist())

    def summary(self, prefix: str = "occ") -> dict:
        ious = np.asarray(self.box_ious)
        vols = np.asarray(self.box_volumes)
        out = {
            f"{prefix}/overall_iou": (self.total_inter / self.total_union
                                      if self.total_union else 0.0),
            f"{prefix}/miou_track": float(np.mean(self.track_ious))
            if self.track_ious else 0.0,
            f"{prefix}/miou_box": float(ious.mean()) if len(ious) else 0.0,
        }
        for name, m in [("small", vols < 30),
                        ("medium", (vols >= 30) & (vols < 150)),
                        ("large", vols >= 150)]:
            if len(ious) and m.any():
                out[f"{prefix}/{name}_box_iou"] = float(ious[m].mean())
        return out


def dense_voxel_centers(size, voxel_size: float) -> np.ndarray:
    """Voxel centres of a size-fitted grid in the gravity-centred box
    frame: dims = ceil(size / vs), centre of cell ``c`` at
    ``c * vs - size / 2 + vs / 2``."""
    size = np.asarray(size, np.float64)
    dims = np.maximum(np.ceil(size / voxel_size), 1).astype(int)
    coors = np.stack(np.meshgrid(*[np.arange(d) for d in dims],
                                 indexing="ij"), -1).reshape(-1, 3)
    return (coors * voxel_size - size / 2
            + voxel_size / 2).astype(np.float32)


def load_full_occ_queries(occ_path: str, voxel_size: float,
                          max_queries: int):
    """Every known voxel centre and its label from an occupancy npz, the
    valid ones first, padded to ``max_queries``. Returns (points [K, 3],
    labels [K], mask [K])."""
    occ = np.load(occ_path)["occ"]
    dims = np.asarray(occ.shape)
    size = dims * voxel_size
    flat = occ.reshape(-1)
    idx = np.nonzero(flat != 0)[0]
    if len(idx) > max_queries:
        idx = idx[np.linspace(0, len(idx) - 1, max_queries).astype(int)]
    coors = np.stack(np.unravel_index(idx, occ.shape), -1)
    centers = (coors + 0.5) * voxel_size - size / 2
    k = len(idx)
    pts = np.zeros((max_queries, 3), np.float32)
    lab = np.zeros((max_queries,), np.int32)
    msk = np.zeros((max_queries,), bool)
    pts[:k] = centers
    lab[:k] = (flat[idx] == 1).astype(np.int32)
    msk[:k] = True
    return pts, lab, msk


# ------------------------------------------------------------------ baseline
def _rot_z_np(pts: np.ndarray, yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    x = pts[..., 0] * c - pts[..., 1] * s
    y = pts[..., 0] * s + pts[..., 1] * c
    return np.stack([x, y, pts[..., 2]], -1)


def occ_baseline_tracklet(points: np.ndarray, points_mask: np.ndarray,
                          rois: np.ndarray, gt_boxes: np.ndarray,
                          gt_valid: np.ndarray, occ_points: np.ndarray,
                          occ_labels: np.ndarray, occ_mask: np.ndarray,
                          voxel_size: float
                          ) -> tuple[np.ndarray, np.ndarray]:
    """The paper's point-aggregation occupancy baseline. For frame ``i``:
    every observed in-box point of frames ``0..i`` (each in its own frame's
    box-local coordinates) marks its voxel of the ``ceil(roi_size /
    voxel_size)`` grid occupied; a GT sample's prediction is its voxel's
    bit (0 outside the grid); inter and union against GT-occupied over the
    known-sample mask.

    points: [L, P, C>=3] shared-frame points; rois / gt_boxes: [L, 7]
    (bottom centre); occ_points: [K, 3] in the gravity-centred GT-box
    frame. Returns (inter [L], union [L]) int64, zero where GT is invalid.
    """
    L = rois.shape[0]
    local_pts = []
    for j in range(L):
        p = points[j][points_mask[j].astype(bool)][:, :3]
        ctr = rois[j, :3] + np.array([0, 0, rois[j, 5] / 2])
        local = _rot_z_np(p - ctr, -rois[j, 6])
        inb = (np.abs(local) <= rois[j, 3:6] / 2).all(-1)
        local_pts.append(local[inb])

    lab = (occ_labels == 1) & occ_mask.astype(bool)
    inter = np.zeros(L, np.int64)
    union = np.zeros(L, np.int64)
    for i in range(L):
        if not gt_valid[i]:
            continue
        agg = (np.concatenate(local_pts[:i + 1], 0) if local_pts[:i + 1]
               else np.zeros((0, 3), np.float32))
        size = rois[i, 3:6]
        dims = np.maximum(np.ceil(size / voxel_size), 1).astype(int)
        grid = np.zeros(dims, bool)
        coors = np.floor((agg + size / 2) / voxel_size).astype(int)
        ok = ((coors >= 0) & (coors < dims)).all(-1)
        coors = coors[ok]
        grid[coors[:, 0], coors[:, 1], coors[:, 2]] = True

        # GT-box frame -> ego -> roi_i frame (gravity-centred both ends)
        gt_ctr = gt_boxes[i, :3] + np.array([0, 0, gt_boxes[i, 5] / 2])
        ego = _rot_z_np(occ_points, gt_boxes[i, 6]) + gt_ctr
        q = _rot_z_np(ego - (rois[i, :3]
                             + np.array([0, 0, rois[i, 5] / 2])),
                      -rois[i, 6])
        qc = np.floor((q + size / 2) / voxel_size).astype(int)
        in_gt = ((qc >= 0) & (qc < dims)).all(-1)
        pred = np.zeros(len(occ_points), bool)
        pred[in_gt] = grid[qc[in_gt, 0], qc[in_gt, 1], qc[in_gt, 2]]

        inter[i] = int((pred & lab).sum())
        union[i] = int((pred | lab).sum())
    return inter, union
