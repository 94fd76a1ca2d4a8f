"""Argoverse 2 sensor-dataset reader (reference ``Argo2Dataset``,
``mmdet3d/datasets/argo2_dataset.py`` + ``run_argo.sh`` FSD configs); a host
copy of the JAX package's ``data/argo2_dataset.py``, sample for sample.
It needs pandas and pyarrow, imported where a feather file is read.

Reads the av2 on-disk layout directly (feather files via pyarrow):
  <root>/<split>/<log_id>/sensors/lidar/<ts>.feather   (x, y, z, intensity)
  <root>/<split>/<log_id>/annotations.feather
      (timestamp_ns, tx_m, ty_m, tz_m, length_m, width_m, height_m,
       qw/qx/qy/qz, category, num_interior_pts)

Boxes convert to this framework's LiDAR layout: av2 centers are gravity
centers (z -= h/2 for bottom), av2 length is along the heading axis and maps
to our l = y_size with yaw = quaternion-yaw - pi/2 rotated into the
(sin, cos) heading convention. Emits the same dense sample dict as
``FrameDataset`` so the detectors train unchanged.
"""
from __future__ import annotations

import os

import numpy as np

ARGO_CLASSES = {
    "REGULAR_VEHICLE": 0, "LARGE_VEHICLE": 0, "BUS": 0, "BOX_TRUCK": 0,
    "TRUCK": 0, "VEHICULAR_TRAILER": 0, "TRUCK_CAB": 0, "SCHOOL_BUS": 0,
    "ARTICULATED_BUS": 0,
    "PEDESTRIAN": 1, "WHEELED_RIDER": 1,
    "BICYCLIST": 2, "MOTORCYCLIST": 2, "BICYCLE": 2, "MOTORCYCLE": 2,
}


def quat_to_yaw(qw, qx, qy, qz):
    """Yaw (rotation about +z) of a quaternion."""
    return np.arctan2(2 * (qw * qz + qx * qy),
                      1 - 2 * (qy * qy + qz * qz))


def av2_box_to_lidar(tx, ty, tz, length, width, height, yaw):
    """av2 gravity-center box -> our [x, y, z_bottom, w, l, h, yaw'].

    av2 length lies along the object's heading (its local +x); our heading
    axis is local +y with heading vector (sin yaw', cos yaw'), so
    yaw' = yaw - pi/2 maps heading consistently and (w, l) = (width,
    length)."""
    return np.asarray([tx, ty, tz - height / 2, width, length, height,
                       yaw - np.pi / 2], np.float32)


class Argo2Dataset:
    def __init__(self, root: str, split: str = "train",
                 max_points: int = 160000, max_gt: int = 128):
        self.base = os.path.join(root, split)
        self.max_points = max_points
        self.max_gt = max_gt
        self.index = []   # (log_id, lidar feather path, ts)
        if os.path.isdir(self.base):
            for log_id in sorted(os.listdir(self.base)):
                ldir = os.path.join(self.base, log_id, "sensors", "lidar")
                if not os.path.isdir(ldir):
                    continue
                for f in sorted(os.listdir(ldir)):
                    if f.endswith(".feather"):
                        self.index.append(
                            (log_id, os.path.join(ldir, f),
                             int(f[:-len(".feather")])))
        self._annos = {}

    def __len__(self):
        return len(self.index)

    @property
    def point_dim(self) -> int:
        """Columns of ``build_sample``'s points: xyz, intensity, 0."""
        return 5

    def _log_annotations(self, log_id: str):
        import pandas as pd
        if log_id not in self._annos:
            path = os.path.join(self.base, log_id, "annotations.feather")
            self._annos[log_id] = (pd.read_feather(path)
                                   if os.path.exists(path) else None)
        return self._annos[log_id]

    def build_sample(self, index: int, rng: np.random.RandomState) -> dict:
        import pandas as pd
        log_id, lidar_path, ts = self.index[index]
        sweep = pd.read_feather(lidar_path)
        cols = [c for c in ("x", "y", "z", "intensity") if c in sweep]
        pts = sweep[cols].to_numpy().astype(np.float32)
        if pts.shape[1] < 5:
            pts = np.pad(pts, ((0, 0), (0, 5 - pts.shape[1])))

        boxes, labels = [], []
        annos = self._log_annotations(log_id)
        if annos is not None:
            rows = annos[annos["timestamp_ns"] == ts]
            for _, r in rows.iterrows():
                cls = ARGO_CLASSES.get(r["category"], -1)
                if cls < 0 or r.get("num_interior_pts", 1) <= 0:
                    continue
                yaw = quat_to_yaw(r["qw"], r["qx"], r["qy"], r["qz"])
                boxes.append(av2_box_to_lidar(
                    r["tx_m"], r["ty_m"], r["tz_m"], r["length_m"],
                    r["width_m"], r["height_m"], yaw))
                labels.append(cls)

        if len(pts) > self.max_points:
            pts = pts[rng.permutation(len(pts))[:self.max_points]]
        n = len(pts)
        points = np.zeros((self.max_points, pts.shape[1]), np.float32)
        points[:n] = pts
        mask = np.arange(self.max_points) < n

        m = min(len(boxes), self.max_gt)
        gt_boxes = np.zeros((self.max_gt, 7), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int32)
        if m:
            gt_boxes[:m] = np.stack(boxes[:m], 0)
            gt_labels[:m] = labels[:m]
        gt_valid = np.arange(self.max_gt) < m
        return dict(points=points, points_mask=mask, gt_boxes=gt_boxes,
                    gt_labels=gt_labels, gt_valid=gt_valid,
                    meta=dict(log_id=log_id, ts=ts))
