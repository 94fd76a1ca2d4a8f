"""Single-frame detection dataset (counterpart of the JAX package's
``data/frame_dataset.py``; a copy of its numpy host code, default path).

Reads the reference's KITTI-format Waymo layout: an infos pkl (a list of
dicts with ``point_cloud.velodyne_path``, ``annos`` in KITTI camera
coordinates and ``calib``) plus float32 ``[N, 6]`` velodyne bins. Camera
annotations become LiDAR boxes through ``inv(R0_rect @ Tr_velo_to_cam)``.

Also the W8 occupancy merge (``occ_pred_root``): the predicted occupancy
centres that the OcOccNet evaluator writes (``evalx/evaluator.py::
save_occ``, float32 ``[K, 4]`` files under ``<root>/<segment>/<ts>/``) join
the frame's cloud as points whose intensity is the occupancy score; and
``sequences``, the frames of each segment in time order (FSD++).

Not ported yet, and refused with ``NotImplementedError``: the geometry
augmentation (``augment``), GT copy-paste (``db_sampler``) and multi-sweep
loading (``num_sweeps``, which widens the points).
"""
from __future__ import annotations

import glob
import os
import pickle

import numpy as np

CLASS_MAP = {"Car": 0, "Pedestrian": 1, "Cyclist": 2}


def _load_pkl(path):
    # the infos file is this dataset's own index, written by
    # write_synthetic_frames or the reference's converter
    with open(path, "rb") as f:
        return pickle.load(f)


def camera_to_lidar_boxes(annos: dict, rect: np.ndarray,
                          trv2c: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """KITTI camera-frame annos -> LiDAR boxes [M, 7] + labels [M]."""
    names = [n for n in annos["name"] if n != "DontCare"]
    keep = np.asarray([n != "DontCare" for n in annos["name"]], bool)
    loc = np.asarray(annos["location"], np.float64)[keep]
    dims = np.asarray(annos["dimensions"], np.float64)[keep]  # l, h, w
    ry = np.asarray(annos["rotation_y"], np.float64)[keep]
    if len(loc) == 0:
        return np.zeros((0, 7), np.float32), np.zeros((0,), np.int32)
    inv = np.linalg.inv(rect @ trv2c)
    loc_h = np.concatenate([loc, np.ones((len(loc), 1))], -1)
    xyz = (loc_h @ inv.T)[:, :3]
    # camera dims (l, h, w) -> lidar (w=x_size, l=y_size, h=z_size); the
    # camera bottom centre maps to the lidar bottom centre directly
    w = dims[:, 2]
    l = dims[:, 0]
    h = dims[:, 1]
    yaw = -ry - np.pi / 2
    boxes = np.stack([xyz[:, 0], xyz[:, 1], xyz[:, 2], w, l, h, yaw],
                     -1).astype(np.float32)
    labels = np.asarray([CLASS_MAP.get(n, -1) for n in names], np.int32)
    ok = labels >= 0
    return boxes[ok], labels[ok]


class FrameDataset:
    def __init__(self, info_path: str, data_root: str,
                 max_points: int = 160000, max_gt: int = 128,
                 occ_pred_root: str | None = None, load_dim: int = 6,
                 use_dim: int = 5, db_sampler=None, augment: bool = False,
                 num_sweeps: int = 0):
        refused = {"db_sampler": db_sampler is not None,
                   "augment": bool(augment), "num_sweeps": num_sweeps > 0}
        for name, asked in refused.items():
            if asked:
                raise NotImplementedError(
                    f"FrameDataset option {name!r} is not ported yet")
        self.infos = _load_pkl(info_path)
        self.data_root = data_root
        self.max_points = max_points
        self.max_gt = max_gt
        self.occ_pred_root = occ_pred_root
        self.load_dim = load_dim
        self.use_dim = use_dim

    def __len__(self):
        return len(self.infos)

    def sequences(self) -> list[list[int]]:
        """Frame indices grouped by driving segment (in name order), each
        in time order: the sequences the FSD++ loader and evaluation walk."""
        groups: dict[str, list[int]] = {}
        for i, info in enumerate(self.infos):
            seg = info.get("segment_name",
                           info["point_cloud"].get("segment_name", ""))
            groups.setdefault(seg, []).append(i)
        key = lambda i: self.infos[i].get("timestamp", i)  # noqa: E731
        return [sorted(ids, key=key) for _, ids in sorted(groups.items())]

    def load_occ_points(self, segment: str, ts) -> np.ndarray:
        """Every predicted occupancy centre of a frame -> [K, use_dim]
        points: xyz, the occupancy score as intensity, zeros elsewhere."""
        d = os.path.join(self.occ_pred_root, segment, str(ts))
        rows = [np.fromfile(f, np.float32).reshape(-1, 4)
                for f in glob.glob(os.path.join(d, "*.bin"))]
        if not rows:
            return np.zeros((0, self.use_dim), np.float32)
        occ = np.concatenate(rows, 0)
        out = np.zeros((len(occ), self.use_dim), np.float32)
        out[:, :4] = occ
        return out

    def build_sample(self, index: int, rng: np.random.RandomState) -> dict:
        """Frame ``index`` padded to the budgets: ``points`` [max_points,
        use_dim] (a random subset from ``rng`` where the frame, with its
        predicted occupancy points, has more),
        ``points_mask``, ``gt_boxes`` [max_gt, 7], ``gt_labels``,
        ``gt_valid``."""
        info = self.infos[index]
        vpath = info["point_cloud"]["velodyne_path"]
        pts = np.fromfile(os.path.join(self.data_root, vpath),
                          np.float32).reshape(-1, self.load_dim)
        pts = pts[:, :self.use_dim]
        if self.occ_pred_root is not None:
            info_seg = info.get("segment_name",
                                info["point_cloud"].get("segment_name", ""))
            pts = np.concatenate([pts, self.load_occ_points(
                info_seg, info.get("timestamp", 0))], 0)

        rect = np.asarray(info["calib"]["R0_rect"], np.float64)
        trv2c = np.asarray(info["calib"]["Tr_velo_to_cam"], np.float64)
        boxes, labels = camera_to_lidar_boxes(info["annos"], rect, trv2c)

        if len(pts) > self.max_points:
            pts = pts[rng.permutation(len(pts))[:self.max_points]]
        n = len(pts)
        points = np.zeros((self.max_points, pts.shape[1]), np.float32)
        points[:n] = pts
        mask = np.arange(self.max_points) < n

        m = min(len(boxes), self.max_gt)
        gt_boxes = np.zeros((self.max_gt, 7), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int32)
        gt_boxes[:m] = boxes[:m]
        gt_labels[:m] = labels[:m]
        gt_valid = np.arange(self.max_gt) < m
        return dict(points=points, points_mask=mask, gt_boxes=gt_boxes,
                    gt_labels=gt_labels, gt_valid=gt_valid)


def write_synthetic_frames(root: str, num_frames: int = 8,
                           num_points: int = 120000, num_boxes: int = 40,
                           seed: int = 0, xy_range: float = 74.0,
                           classes=("Car", "Pedestrian", "Cyclist")) -> str:
    """Write a file-backed synthetic KITTI-format frame dataset at
    production scale (the point and box budgets of the Waymo configs), for
    full-scale detector training without the real data. Per frame a
    velodyne ``.bin`` ([N, 6] float32); an ``infos.pkl`` with camera-frame
    KITTI annos. Returns the infos path. The same seed writes the same
    files as the JAX package's function."""
    if num_points < 64 * num_boxes:
        raise ValueError(
            f"num_points ({num_points}) must be >= 64 * num_boxes "
            f"({64 * num_boxes}): each box claims 64 foreground points")
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    rect = np.eye(4)
    trv2c = np.asarray([[0, -1, 0, 0], [0, 0, -1, 0],
                        [1, 0, 0, 0], [0, 0, 0, 1]], np.float64)
    names_pool = list(classes)
    box_range = xy_range * (60.0 / 74.0)
    sizes = {"Car": (2.1, 4.8, 1.8), "Pedestrian": (0.9, 0.9, 1.7),
             "Cyclist": (0.85, 1.8, 1.7)}
    infos = []
    for i in range(num_frames):
        # ground and ambient returns across the full range
        n_bg = num_points - 64 * num_boxes
        bg = np.concatenate([
            rng.uniform(-xy_range, xy_range, (n_bg, 2)),
            rng.uniform(-0.3, 0.3, (n_bg, 1)) - 1.7], -1)
        pts = [bg]
        names, locs, dims, rys = [], [], [], []
        for _ in range(num_boxes):
            name = names_pool[int(rng.randint(len(names_pool)))]
            w, l, h = sizes[name]
            ctr = np.array([rng.uniform(-box_range, box_range),
                            rng.uniform(-box_range, box_range),
                            rng.uniform(-1.8, -1.2)])
            yaw = rng.uniform(-np.pi, np.pi)
            local = rng.uniform(-0.45, 0.45, (64, 3)) * np.array([w, l, h])
            c, s = np.cos(yaw), np.sin(yaw)
            obj = np.stack([local[:, 0] * c - local[:, 1] * s,
                            local[:, 0] * s + local[:, 1] * c,
                            local[:, 2] + h / 2], -1) + ctr
            pts.append(obj)
            cam = (rect @ trv2c) @ np.concatenate([ctr, [1.0]])
            names.append(name)
            locs.append(cam[:3])
            dims.append([l, h, w])
            rys.append(-yaw - np.pi / 2)
        xyz = np.concatenate(pts, 0)
        arr = np.concatenate(
            [xyz, rng.rand(len(xyz), 3).astype(np.float64)],
            -1).astype(np.float32)
        vp = f"velodyne/{i:06d}.bin"
        arr.tofile(os.path.join(root, vp))
        # ego pose drifting forward along x (for multi-sweep loading)
        pose = np.eye(4)
        pose[0, 3] = 2.0 * i
        sweeps = [dict(velodyne_path=infos[j]["point_cloud"]
                       ["velodyne_path"], pose=infos[j]["pose"])
                  for j in range(i - 1, -1, -1)]
        infos.append(dict(
            point_cloud=dict(velodyne_path=vp),
            calib=dict(R0_rect=rect, Tr_velo_to_cam=trv2c),
            annos=dict(name=np.asarray(names),
                       location=np.asarray(locs),
                       dimensions=np.asarray(dims),
                       rotation_y=np.asarray(rys)),
            timestamp=1000 + i, segment_name="synth-seg",
            pose=pose, sweeps=sweeps))
    info_path = os.path.join(root, "infos.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return info_path
