"""Indoor frame datasets: ScanNet + SUN RGB-D (mmdet3d info-pkl format); a
host copy of the JAX package's ``data/indoor_dataset.py``, sample for
sample.

Counterpart of the reference's ``ScanNetDataset`` / ``SUNRGBDDataset``
(``mmdet3d/datasets/scannet_dataset.py:18-150``,
``sunrgbd_dataset.py:14-170``): reads the standard converted infos pkl —
each info carries ``pts_path`` (float32 .bin, xyz + rgb columns) and
``annos`` with ``gt_boxes_upright_depth`` (gravity-centered; ScanNet
axis-aligned [cx, cy, cz, dx, dy, dz] + an ``axis_align_matrix`` applied
to the points, SUN RGB-D rotated 7-dof) and ``class`` labels — and
produces the same static padded sample dict as the outdoor FrameDataset,
with boxes in this framework's bottom-center layout (yaw 0 for ScanNet).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

SCANNET_CLASSES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "showercurtrain", "toilet", "sink", "bathtub", "garbagebin")

SUNRGBD_CLASSES = (
    "bed", "table", "sofa", "chair", "toilet", "desk", "dresser",
    "night_stand", "bookshelf", "bathtub")


class ScanNetDataset:
    CLASSES = SCANNET_CLASSES
    ALIGN_POINTS = True

    def __init__(self, info_path: str, data_root: str, classes=None,
                 max_points: int = 40000, max_gt: int = 64,
                 load_dim: int = 6):
        self.classes = list(classes if classes is not None else self.CLASSES)
        self.data_root = data_root
        self.max_points = max_points
        self.max_gt = max_gt
        self.load_dim = load_dim
        with open(info_path, "rb") as f:
            self.infos = pickle.load(f)

    def __len__(self):
        return len(self.infos)

    @property
    def point_dim(self) -> int:
        """Columns of ``build_sample``'s points: xyz and rgb."""
        return self.load_dim

    def load_points(self, info: dict) -> np.ndarray:
        path = os.path.join(self.data_root, info["pts_path"])
        pts = np.fromfile(path, np.float32).reshape(-1, self.load_dim)
        if self.ALIGN_POINTS:
            m = np.asarray(info.get(
                "annos", {}).get("axis_align_matrix", np.eye(4)),
                np.float64)
            pts = pts.copy()
            pts[:, :3] = pts[:, :3] @ m[:3, :3].T + m[:3, 3]
        return pts

    def parse_annotations(self, info: dict):
        annos = info.get("annos", {})
        if not annos or int(annos.get("gt_num", 0)) == 0:
            return np.zeros((0, 7), np.float32), np.zeros((0,), np.int32)
        raw = np.asarray(annos["gt_boxes_upright_depth"], np.float32)
        labels = np.asarray(annos["class"], np.int64).astype(np.int32)
        boxes = np.zeros((len(raw), 7), np.float32)
        boxes[:, :6] = raw[:, :6]
        if raw.shape[1] >= 7:
            boxes[:, 6] = raw[:, 6]
        # gravity-centered -> bottom-center z
        boxes[:, 2] -= boxes[:, 5] / 2.0
        keep = labels < len(self.classes)
        return boxes[keep], labels[keep]

    def build_sample(self, index: int, rng) -> dict:
        info = self.infos[index]
        pts = self.load_points(info)
        if len(pts) > self.max_points:
            sel = rng.choice(len(pts), self.max_points, replace=False)
            pts = pts[sel]
        points = np.zeros((self.max_points, pts.shape[1]), np.float32)
        points[:len(pts)] = pts
        mask = np.arange(self.max_points) < len(pts)

        boxes, labels = self.parse_annotations(info)
        m = min(len(boxes), self.max_gt)
        gt_boxes = np.zeros((self.max_gt, 7), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int32)
        gt_boxes[:m] = boxes[:m]
        gt_labels[:m] = labels[:m]
        gt_valid = np.arange(self.max_gt) < m
        sid = info.get("point_cloud", {}).get("lidar_idx", index)
        return dict(points=points, points_mask=mask, gt_boxes=gt_boxes,
                    gt_labels=gt_labels, gt_valid=gt_valid,
                    meta=dict(scene=str(sid)))


class SUNRGBDDataset(ScanNetDataset):
    """SUN RGB-D shares the infos layout; boxes carry a yaw and points are
    already in the depth frame (no axis alignment)."""
    CLASSES = SUNRGBD_CLASSES
    ALIGN_POINTS = False


def write_indoor_scenes(root: str, num_scenes: int = 2,
                        num_points: int = 50000, yawed: bool = False,
                        num_boxes: int = 12, seed: int = 0) -> str:
    """Write ``num_scenes`` synthetic rooms in the ScanNet / SUN RGB-D
    info-pkl layout (the layout the JAX package's reader tests write): per
    scene a ``.bin`` of ``num_points`` float32 rows (xyz in an 8 x 8 x 3 m
    room, rgb in [0, 1]), a third of them on ``num_boxes`` objects, and its
    info with ``gt_boxes_upright_depth`` (gravity-centred; 7 columns with a
    yaw when ``yawed``, the SUN RGB-D form), ``class`` labels of the
    dataset's classes and an ``axis_align_matrix`` (a rotation about z and
    a shift; the ScanNet form stores the points before it, so that the
    reader's alignment puts them back on the boxes). Returns the infos
    path."""
    rng = np.random.RandomState(seed)
    ncls = len(SUNRGBD_CLASSES if yawed else SCANNET_CLASSES)
    os.makedirs(os.path.join(root, "points"), exist_ok=True)
    infos = []
    for i in range(num_scenes):
        ctr = np.concatenate([rng.uniform(1, 7, (num_boxes, 2)),
                              rng.uniform(0.4, 1.5, (num_boxes, 1))], -1)
        size = rng.uniform(0.4, 1.6, (num_boxes, 3))
        yaw = rng.uniform(-np.pi, np.pi, num_boxes) if yawed \
            else np.zeros(num_boxes)
        k = num_points // 3
        owner = rng.randint(num_boxes, size=k)
        local = (rng.rand(k, 3) - 0.5) * size[owner]
        c, s = np.cos(yaw[owner]), np.sin(yaw[owner])
        on = np.stack([c * local[:, 0] - s * local[:, 1],
                       s * local[:, 0] + c * local[:, 1], local[:, 2]], -1)
        xyz = np.concatenate([on + ctr[owner], rng.uniform(
            [0, 0, 0], [8, 8, 3], (num_points - k, 3))])
        a = rng.uniform(-0.3, 0.3)
        align = np.eye(4)
        align[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        align[:3, 3] = [-4.0, -4.0, 0.0]
        if not yawed:     # ScanNet stores the scan before its alignment
            xyz = (xyz - align[:3, 3]) @ align[:3, :3]
        pts = np.concatenate([xyz, rng.rand(num_points, 3)], -1)
        path = f"points/scene{i}.bin"
        pts.astype(np.float32).tofile(os.path.join(root, path))
        boxes = np.concatenate([ctr, size] + ([yaw[:, None]] if yawed
                                              else []), -1)
        infos.append(dict(
            point_cloud=dict(lidar_idx=f"scene{i}"), pts_path=path,
            annos=dict(gt_num=num_boxes,
                       gt_boxes_upright_depth=boxes.astype(np.float32),
                       axis_align_matrix=align,
                       **{"class": rng.randint(0, ncls, num_boxes)})))
    info_path = os.path.join(root, "infos.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return info_path
