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

The training pipeline: multi-sweep loading (``num_sweeps``, which adds a
time-lag column: the points are ``use_dim + 1`` wide), GT copy-paste
(``db_sampler``, ``data/dbsampler.py``) and the geometry augmentation
(``augment``), in the JAX package's order and draw for draw the same with
the same ``RandomState``.
"""
from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from .dbsampler import apply_db_sample
from .tracklet_dataset import apply_flip, apply_rot_scale_trans

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
                 flip_ratio_horizontal: float = 0.5,
                 flip_ratio_vertical: float = 0.0,
                 rot_range=(-0.78539816, 0.78539816),
                 scale_range=(0.95, 1.05),
                 translation_std=(0.0, 0.0, 0.0),
                 pc_range=None, num_sweeps: int = 0):
        """``augment=True`` turns on the reference's frame augmentation
        (``configs/_base_/datasets/waymo-*.py``: RandomFlip3D ->
        GlobalRotScaleTrans(rot +-pi/4, scale [0.95, 1.05]) ->
        Points/ObjectRangeFilter) through ``tracklet_dataset.apply_flip`` and
        ``apply_rot_scale_trans``. ``pc_range`` (6 floats) turns on the range
        filters: points outside are masked out and boxes whose BEV centre
        leaves the range are invalidated. ``db_sampler`` (a
        ``dbsampler.DBSampler``) pastes GT crops before the augmentation.
        ``num_sweeps`` > 0 appends up to that many earlier sweeps of the
        frame's ``info["sweeps"]`` and a time-lag column."""
        self.infos = _load_pkl(info_path)
        self.data_root = data_root
        self.max_points = max_points
        self.max_gt = max_gt
        self.occ_pred_root = occ_pred_root
        self.load_dim = load_dim
        self.use_dim = use_dim
        self.db_sampler = db_sampler
        self.augment = augment
        self.flip_ratio_horizontal = flip_ratio_horizontal
        self.flip_ratio_vertical = flip_ratio_vertical
        self.rot_range = tuple(rot_range)
        self.scale_range = tuple(scale_range)
        self.translation_std = tuple(translation_std)
        self.pc_range = None if pc_range is None else tuple(pc_range)
        self.num_sweeps = num_sweeps

    @property
    def point_dim(self) -> int:
        """Columns of ``build_sample``'s points: ``use_dim``, plus the
        time-lag column with sweeps."""
        return self.use_dim + (self.num_sweeps > 0)

    def _cat_sweeps(self, pts: np.ndarray, info: dict) -> np.ndarray:
        """Concatenate up to ``num_sweeps`` earlier sweeps into the frame
        (the reference's ``LoadPointsFromMultiSweepsWaymo``,
        ``datasets/pipelines/loading.py:703-871``): each sweep's points go
        past ego -> world (the sweep's pose) -> current ego (the inverse of
        this frame's pose) in float64, and a trailing time-lag column holds
        0 for the frame and ``-(idx+1)`` for its idx-th sweep. A frame
        without sweeps only gains the zero column."""
        out = [np.concatenate(
            [pts, np.zeros((len(pts), 1), np.float32)], -1)]
        curr_pose = np.asarray(info.get("pose", np.eye(4)), np.float64)
        world2curr = np.linalg.inv(curr_pose)
        for idx, sweep in enumerate(info.get("sweeps", [])):
            if idx >= self.num_sweeps:
                break
            spath = os.path.join(
                os.path.dirname(os.path.join(self.data_root,
                                             info["point_cloud"]
                                             ["velodyne_path"])),
                os.path.basename(sweep["velodyne_path"]))
            sp = np.fromfile(spath, np.float32).reshape(-1, self.load_dim)
            sp = sp[:, :self.use_dim]
            past = np.asarray(sweep["pose"], np.float64)
            world = sp[:, :3] @ past[:3, :3].T + past[:3, 3]
            sp[:, :3] = (world @ world2curr[:3, :3].T
                         + world2curr[:3, 3]).astype(np.float32)
            lag = np.full((len(sp), 1), -(idx + 1), np.float32)
            out.append(np.concatenate([sp, lag], -1))
        return np.concatenate(out, 0)

    def _augment(self, sample: dict, rng: np.random.RandomState) -> dict:
        """Geometry augmentation of the padded sample, after the GT paste
        (the reference's ObjectSample -> flip -> rot/scale order); padded
        rows transform harmlessly under their masks."""
        pts = sample["points"]
        boxes = sample["gt_boxes"]
        if rng.rand() < self.flip_ratio_horizontal:
            apply_flip(pts, [boxes], True)
        if rng.rand() < self.flip_ratio_vertical:
            apply_flip(pts, [boxes], False)
        ang = rng.uniform(*self.rot_range)
        sc = rng.uniform(*self.scale_range)
        std = np.asarray(self.translation_std, np.float64)
        tr = (rng.normal(scale=std, size=3) if std.any()
              else np.zeros(3)).astype(np.float32)
        apply_rot_scale_trans(pts, [boxes], ang, sc, tr)
        if self.pc_range is not None:
            lo = np.asarray(self.pc_range[:3], np.float32)
            hi = np.asarray(self.pc_range[3:], np.float32)
            sample["points_mask"] &= np.all(
                (pts[:, :3] >= lo) & (pts[:, :3] <= hi), axis=-1)
            ctr = boxes[:, :2]
            sample["gt_valid"] &= np.all(
                (ctr >= lo[:2]) & (ctr <= hi[:2]), axis=-1)
        return sample

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
        points: xyz, the occupancy score as intensity, zeros elsewhere (and
        in the time-lag column that sweeps add)."""
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
        point_dim] (a random subset from ``rng`` where the frame, with its
        sweeps and predicted occupancy points, has more),
        ``points_mask``, ``gt_boxes`` [max_gt, 7], ``gt_labels``,
        ``gt_valid``; then the GT paste and the augmentation, each where it
        is on."""
        info = self.infos[index]
        vpath = info["point_cloud"]["velodyne_path"]
        pts = np.fromfile(os.path.join(self.data_root, vpath),
                          np.float32).reshape(-1, self.load_dim)
        pts = pts[:, :self.use_dim]
        if self.num_sweeps > 0:
            pts = self._cat_sweeps(pts, info)
        if self.occ_pred_root is not None:
            info_seg = info.get("segment_name",
                                info["point_cloud"].get("segment_name", ""))
            occ = self.load_occ_points(info_seg, info.get("timestamp", 0))
            occ = np.pad(occ, ((0, 0), (0, pts.shape[1] - occ.shape[1])))
            pts = np.concatenate([pts, occ], 0)

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
        sample = dict(points=points, points_mask=mask, gt_boxes=gt_boxes,
                      gt_labels=gt_labels, gt_valid=gt_valid)
        if self.db_sampler is not None:
            sample = apply_db_sample(sample, self.db_sampler)
        if self.augment:
            sample = self._augment(sample, rng)
        return sample


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
