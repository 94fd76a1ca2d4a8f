"""Seeded inputs of the W1 annotator at Waymo's sizes, for the benchmark and
the card's checks.

``make_realistic_scene``: one car tracklet of ``T`` frames, each with
160,000 background points and 150-400 points on the car's faces, and five
LiDARs (TOP 64 x 2650, four more 200 x 600) whose virtual range images read
5-70 m at random: a copy of the JAX repository's
``benchmarks/bench_annotate.py::make_realistic_scene``.

``write_annotation_dataset``: the files of the data-prep CLI
(``tools/create_data.py``): ``write_synthetic_frames`` frames of cars split
into
segments, per-segment raw frame pkls (``<root>/raw/<segment>/<ts>.pkl``)
whose range images are built from each frame's own points seen from five
LiDARs, and GT and predicted tracklet ``.bin`` files that follow the
frames' cars.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..data.frame_dataset import camera_to_lidar_boxes, write_synthetic_frames
from ..evalx.waymo_bin import WaymoObject, write_bin
from .range_image import build_virtual_range_image

# (rows, columns) of each LiDAR's virtual range image
SENSORS = {"TOP": (64, 2650), "FRONT": (200, 600), "SIDE_LEFT": (200, 600),
           "SIDE_RIGHT": (200, 600), "REAR": (200, 600)}
# the LiDARs' mounting: yaw and position on the vehicle
MOUNTS = {"TOP": (0.0, (1.4, 0.0, 2.2)), "FRONT": (0.0, (4.1, 0.0, 0.7)),
          "SIDE_LEFT": (np.pi / 2, (3.0, 1.0, 0.9)),
          "SIDE_RIGHT": (-np.pi / 2, (3.0, -1.0, 0.9)),
          "REAR": (np.pi, (-1.1, 0.0, 0.9))}


def make_realistic_scene(T: int = 100, seed: int = 0):
    """-> (boxes [T, 7], ts_list, get_points(ts), get_raw_frame(ts))."""
    rng = np.random.RandomState(seed)
    size = np.array([4.8, 2.1, 1.8])
    boxes = []
    for i in range(T):
        ctr = np.array([12.0 + 0.35 * i, -3.0 + 0.05 * i, -0.9])
        yaw = 0.2 + 0.002 * i
        boxes.append(np.concatenate([ctr, size, [yaw]]))
    boxes = np.asarray(boxes, np.float32)

    pts_per_frame = []
    for i in range(T):
        n_bg = 160_000
        bg = rng.uniform([-75, -75, -2], [75, 75, 4], (n_bg, 3))
        n_obj = rng.randint(150, 400)
        u = rng.uniform(-0.5, 0.5, (n_obj, 3))
        face = rng.randint(0, 3, n_obj)
        sgn = rng.choice([-0.5, 0.5], n_obj)
        for a in range(3):
            u[face == a, a] = sgn[face == a]
        local = u * size
        b = boxes[i]
        c, s = np.cos(b[6]), np.sin(b[6])
        obj = np.stack([local[:, 0] * c - local[:, 1] * s + b[0],
                        local[:, 0] * s + local[:, 1] * c + b[1],
                        local[:, 2] + b[2] + size[2] / 2], -1)
        pts_per_frame.append(
            np.concatenate([obj, bg], 0).astype(np.float32))

    lidars = {}
    for name, (H, W) in SENSORS.items():
        incl = np.linspace(-0.31, 0.04, H).astype(np.float32)
        ext = np.eye(4, dtype=np.float32)
        ri = rng.uniform(5.0, 70.0, (H, W)).astype(np.float32)
        lidars[name] = (np.flip(incl).copy(), ext, ri)

    def get_points(ts):
        return pts_per_frame[ts]

    def get_raw_frame(ts):
        out = {}
        for name, (incl, ext, ri) in lidars.items():
            out[f"{name}_BEAM_INCLINATION"] = incl
            out[f"{name}_LIDAR_EXTRINSIC"] = ext
            out[f"{name}_RANGE_IMAGE_MERGE_VIRTUAL"] = ri
        return out

    return boxes, list(range(T)), get_points, get_raw_frame


def sensor_raw_frame(points: np.ndarray, sensors=SENSORS) -> dict:
    """The annotator's raw dict of one frame: per LiDAR its extrinsic
    (``MOUNTS``), its beam inclinations (stored descending, as Waymo's) and
    the virtual range image of ``points`` [N, >=3] (ego) seen from it (rows
    ascending, empty cells 0)."""
    out = {}
    for name, (H, W) in sensors.items():
        yaw, pos = MOUNTS[name]
        ext = np.eye(4)
        ext[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw),
                                                     np.cos(yaw)]]
        ext[:3, 3] = pos
        incl = np.linspace(-0.31 if name == "TOP" else -1.2,
                           0.04 if name == "TOP" else 0.5, H)
        out[f"{name}_LIDAR_EXTRINSIC"] = ext
        out[f"{name}_BEAM_INCLINATION"] = np.flip(incl).astype(np.float32)
        out[f"{name}_RANGE_IMAGE_MERGE_VIRTUAL"] = build_virtual_range_image(
            points[:, :3], ext, incl, W)
    return out


def write_annotation_dataset(root: str, segments: int = 2,
                             frames_per_segment: int = 10,
                             tracklets_per_segment: int = 2,
                             num_points: int = 120000, num_boxes: int = 40,
                             sensors=SENSORS, seed: int = 0) -> dict:
    """Write the data-prep CLI's inputs under ``root``: the frames
    (``infos.pkl``, ``velodyne/``, every box a car; ``segments`` segments
    of ``frames_per_segment`` frames, timestamps 1000, 1001, ...), the raw
    frame pkls (``raw/<segment>/<ts>.pkl``), ``gt.bin`` (per segment
    ``tracklets_per_segment`` vehicle tracklets over every frame: tracklet
    k holds the k-th car of each frame) and ``pred.bin`` (the same boxes
    moved by up to 5 cm, score 0.8). Returns the paths."""
    n = segments * frames_per_segment
    if num_boxes < tracklets_per_segment:
        raise ValueError(f"{num_boxes} boxes per frame, fewer than "
                         f"{tracklets_per_segment} tracklets")
    infos_path = write_synthetic_frames(root, num_frames=n,
                                        num_points=num_points,
                                        num_boxes=num_boxes, seed=seed,
                                        classes=("Car",))
    with open(infos_path, "rb") as f:
        infos = pickle.load(f)
    rng = np.random.RandomState(seed + 1)
    gt, pred = [], []
    for i, info in enumerate(infos):
        seg = f"seg-{i // frames_per_segment}"
        info["segment_name"] = seg
        # the earlier frames of the same segment only
        info["sweeps"] = info["sweeps"][:i % frames_per_segment]
        ts = int(info["timestamp"])
        pts = np.fromfile(os.path.join(root, info["point_cloud"]
                                       ["velodyne_path"]),
                          np.float32).reshape(-1, 6)
        raw_dir = os.path.join(root, "raw", seg)
        os.makedirs(raw_dir, exist_ok=True)
        with open(os.path.join(raw_dir, f"{ts}.pkl"), "wb") as f:
            pickle.dump(sensor_raw_frame(pts, sensors), f)
        boxes, _ = camera_to_lidar_boxes(info["annos"],
                                         info["calib"]["R0_rect"],
                                         info["calib"]["Tr_velo_to_cam"])
        for k, box in enumerate(boxes[:tracklets_per_segment]):
            gt.append(WaymoObject(tuple(box), 1.0, 1, f"gt_{k}", seg, ts,
                                  num_lidar_points=64, difficulty=1))
            noisy = box + rng.uniform(-0.05, 0.05, 7).astype(np.float32)
            pred.append(WaymoObject(tuple(noisy), 0.8, 1, f"pd_{k}", seg,
                                    ts))
    with open(infos_path, "wb") as f:
        pickle.dump(infos, f)
    paths = dict(infos=infos_path, data_root=root,
                 raw_root=os.path.join(root, "raw"),
                 gt_bin=os.path.join(root, "gt.bin"),
                 pred_bin=os.path.join(root, "pred.bin"))
    write_bin(gt, paths["gt_bin"])
    write_bin(pred, paths["pred_bin"])
    return paths
