"""NuScenes / Lyft frame datasets (mmdet3d info-pkl format); a host copy
of the JAX package's ``data/nuscenes_dataset.py``, sample for sample.

Counterpart of the reference's ``NuScenesDataset`` / ``LyftDataset``
(``mmdet3d/datasets/nuscenes_dataset.py:23-330``,
``lyft_dataset.py:20-120``): reads the standard converted ``*_infos_*.pkl``
(each info carries ``lidar_path``, ``sweeps``, ``gt_boxes`` with the
(0.5, 0.5, 0.5) gravity-center origin, ``gt_names``, ``num_lidar_pts``/
``valid_flag``, ``timestamp``) and produces the same static padded sample
dict as ``FrameDataset`` — points [N, 5] with the 5th channel holding the
sweep time lag, boxes converted to this framework's bottom-center layout.

Sweep aggregation mirrors ``LoadPointsFromMultiSweeps``
(``datasets/pipelines/loading.py:205-235``): each sweep's points rotate/
translate into the key frame with ``sensor2lidar_*`` and carry
``ts - sweep_ts`` in the time channel.

Detection on these datasets evaluates through the same ``kitti_eval``
protocol used by the frame evaluator (the official NDS/Lyft-mAP services
need their respective devkits and live outside this framework).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

NUSCENES_CLASSES = (
    "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
    "motorcycle", "pedestrian", "traffic_cone", "barrier")

LYFT_CLASSES = (
    "car", "truck", "bus", "emergency_vehicle", "other_vehicle",
    "motorcycle", "bicycle", "pedestrian", "animal")


class NuScenesDataset:
    CLASSES = NUSCENES_CLASSES

    def __init__(self, info_path: str, data_root: str,
                 classes=None, max_points: int = 40000, max_gt: int = 128,
                 max_sweeps: int = 0, load_dim: int = 5,
                 use_valid_flag: bool = False):
        self.classes = list(classes if classes is not None else self.CLASSES)
        self.data_root = data_root
        self.max_points = max_points
        self.max_gt = max_gt
        self.max_sweeps = max_sweeps
        self.load_dim = load_dim
        self.use_valid_flag = use_valid_flag
        with open(info_path, "rb") as f:
            data = pickle.load(f)
        self.infos = data["infos"] if isinstance(data, dict) else data
        self.infos = sorted(self.infos,
                            key=lambda i: i.get("timestamp", 0))

    def __len__(self):
        return len(self.infos)

    @property
    def point_dim(self) -> int:
        """Columns of ``build_sample``'s points: xyz, intensity, time lag."""
        return 5

    # ------------------------------------------------------------- points
    def _load_points(self, path: str) -> np.ndarray:
        full = path if os.path.isabs(path) else os.path.join(
            self.data_root, path)
        pts = np.fromfile(full, np.float32)
        return pts.reshape(-1, self.load_dim)

    def load_frame_points(self, info: dict) -> np.ndarray:
        """Key frame + up to ``max_sweeps`` motion-compensated sweeps;
        out [N, 5] = xyz, intensity, time-lag (seconds)."""
        pts = self._load_points(info["lidar_path"])[:, :4]
        out = [np.concatenate(
            [pts, np.zeros((len(pts), 1), np.float32)], -1)]
        ts = info.get("timestamp", 0) / 1e6
        for sweep in list(info.get("sweeps", []))[:self.max_sweeps]:
            sp = self._load_points(sweep["data_path"])[:, :4]
            rot = np.asarray(sweep["sensor2lidar_rotation"], np.float64)
            trans = np.asarray(sweep["sensor2lidar_translation"],
                               np.float64)
            xyz = sp[:, :3] @ rot.T + trans
            lag = ts - sweep.get("timestamp", 0) / 1e6
            out.append(np.concatenate(
                [xyz.astype(np.float32), sp[:, 3:4],
                 np.full((len(sp), 1), lag, np.float32)], -1))
        return np.concatenate(out, 0)

    # -------------------------------------------------------------- boxes
    def _gt_mask(self, info: dict) -> np.ndarray:
        n = len(info["gt_boxes"])
        if self.use_valid_flag and "valid_flag" in info:
            return np.asarray(info["valid_flag"], bool)
        if "num_lidar_pts" in info:
            return np.asarray(info["num_lidar_pts"]) > 0
        return np.ones(n, bool)

    def parse_annotations(self, info: dict):
        """-> (boxes [M, 7] bottom-center layout, labels [M])."""
        mask = self._gt_mask(info)
        boxes = np.asarray(info["gt_boxes"], np.float32)[mask][:, :7]
        names = np.asarray(info["gt_names"])[mask]
        labels = np.asarray(
            [self.classes.index(n) if n in self.classes else -1
             for n in names], np.int32)
        keep = labels >= 0
        boxes, labels = boxes[keep].copy(), labels[keep]
        # nuscenes boxes are gravity-centered (origin 0.5, 0.5, 0.5);
        # this framework uses bottom centers
        boxes[:, 2] -= boxes[:, 5] / 2.0
        return boxes, labels

    # ------------------------------------------------------------- sample
    def build_sample(self, index: int, rng) -> dict:
        info = self.infos[index]
        pts = self.load_frame_points(info)
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
        return dict(points=points, points_mask=mask, gt_boxes=gt_boxes,
                    gt_labels=gt_labels, gt_valid=gt_valid,
                    meta=dict(token=info.get("token", str(index)),
                              timestamp=info.get("timestamp", 0)))


class LyftDataset(NuScenesDataset):
    """Lyft shares the nuscenes info format (its converter is the
    nuscenes one with the Lyft class set and no velocity)."""
    CLASSES = LYFT_CLASSES


def write_nuscenes_frames(root: str, num_frames: int = 3,
                          num_points: int = 30000, num_sweeps: int = 1,
                          pc_range=(-50.0, -50.0, -2.0, 50.0, 50.0, 4.0),
                          num_boxes: int = 20, seed: int = 0) -> str:
    """Write ``num_frames`` synthetic key frames in the nuScenes info-pkl
    layout (the layout the JAX package's reader tests write): per frame a
    ``.bin`` of ``num_points`` float32 rows (x, y, z, intensity, ring)
    inside ``pc_range`` with a tenth of them on the boxes, ``num_sweeps``
    earlier sweeps (``sensor2lidar_*`` a small motion, 50 ms apart) and
    ``num_boxes`` gravity-centred boxes named from nuScenes' classes with
    their point counts. Returns the infos path."""
    rng = np.random.RandomState(seed)
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:])
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)

    def cloud(n, boxes):
        pts = rng.uniform(lo, hi - 1e-3, (n, 3))
        k = n // 10
        on = boxes[rng.randint(len(boxes), size=k)]
        pts[:k] = np.clip(on[:, :3] + (rng.rand(k, 3) - 0.5) * on[:, 3:6],
                          lo, hi - 1e-3)
        return np.concatenate([pts, rng.rand(n, 1) * 255,
                               rng.randint(0, 32, (n, 1))], -1).astype(
            np.float32)

    infos = []
    for i in range(num_frames):
        ctr = rng.uniform(lo + 5, hi - 5, (num_boxes, 3))
        ctr[:, 2] = rng.uniform(lo[2] + 1, hi[2] - 1, num_boxes)
        size = np.abs(rng.normal([1.9, 4.5, 1.7], 0.2, (num_boxes, 3)))
        boxes = np.concatenate([ctr, size, rng.uniform(
            -np.pi, np.pi, (num_boxes, 1))], -1).astype(np.float32)
        ts = (1000 + i) * 1e6
        path = f"samples/frame{i}.bin"
        cloud(num_points, boxes).tofile(os.path.join(root, path))
        sweeps = []
        for j in range(num_sweeps):
            spath = f"samples/frame{i}_sweep{j}.bin"
            cloud(num_points, boxes).tofile(os.path.join(root, spath))
            a = 0.002 * (j + 1)
            rot = np.array([[np.cos(a), -np.sin(a), 0.0],
                            [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
            sweeps.append(dict(data_path=spath, sensor2lidar_rotation=rot,
                               sensor2lidar_translation=np.array(
                                   [0.3 * (j + 1), 0.0, 0.0]),
                               timestamp=ts - 5e4 * (j + 1)))
        infos.append(dict(
            token=f"tok{i}", timestamp=ts, lidar_path=path, sweeps=sweeps,
            gt_boxes=boxes,
            gt_names=np.asarray(NUSCENES_CLASSES)[
                rng.randint(0, len(NUSCENES_CLASSES), num_boxes)],
            num_lidar_pts=rng.randint(0, 200, num_boxes),
            valid_flag=np.ones(num_boxes, bool)))
    info_path = os.path.join(root, "nus_infos.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(dict(infos=infos, metadata=dict(version="synthetic")), f)
    return info_path
