"""CTRL leaderboard tooling: track extension by velocity extrapolation,
bin merging, and pose extraction (a copy of the JAX package's
``tools_ctrl/extend_tracks.py``; the port imports nothing of that package).

Rebuilds ``tools/ctrl/extend_tracks.py`` + the tracklet velocity/extend ops
(``core/bbox/structures/lidar_tracklet.py:638-790``),
``tools/ctrl/merge_bins.py`` and ``tools/ctrl/extract_poses.py`` on this
framework's numpy ``TrackletRecord`` + in-tree proto ``.bin`` IO (no waymo
dependency).

Semantics mirrored from the reference:
  * velocities are finite differences of box centers in a SHARED frame (the
    track's first ego pose), first velocity duplicated;
  * backward extension clones the first box, shifts xy by
    ``mean(velocity[:window]) * dt`` for each earlier timestamp of the
    segment, decays scores by ``score_multiplier ** (i+1)``, and skips
    tracks shorter than ``min_length`` or with a frame gap > 0.5 s;
  * ``extend_all`` additionally extrapolates forward from the last box;
  * extended boxes transform back into each new frame's ego pose before
    writing the output bin.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from collections import defaultdict

import numpy as np

from ..data.tracklet_dataset import (TrackletRecord, pose_transform_boxes)


def shared_frame_boxes(rec: TrackletRecord, poses: dict) -> np.ndarray:
    """Per-frame ego boxes -> the first frame's pose frame
    (``frame_transform(pose_list[0])``)."""
    src = np.stack([poses[t] for t in rec.ts], 0)
    tgt_inv = np.linalg.inv(poses[rec.ts[0]])
    return pose_transform_boxes(rec.boxes, src, tgt_inv)


def track_velocity(boxes_shared: np.ndarray, ts: list) -> np.ndarray:
    """[T, 3] per-frame velocity (``LiDARTracklet.set_velocity``): center
    deltas over dt, first row duplicated; zeros for length <= 1."""
    T = len(ts)
    if T <= 1:
        return np.zeros((T, 3), np.float64)
    ctr = boxes_shared[:, :3].astype(np.float64)
    t = (np.asarray(ts, np.float64) - ts[0]) / 1e6
    velo = (ctr[1:] - ctr[:-1]) / (t[1:] - t[:-1])[:, None]
    return np.concatenate([velo[:1], velo], 0)


def _extrapolate(rec: TrackletRecord, boxes_shared, velo, poses,
                 target_ts: list, anchor_idx: int, velo_rows: np.ndarray,
                 score_multiplier: float):
    """Clone the anchor box at each target ts, xy-shifted by mean velocity;
    returns (ego boxes [K, 7], scores [K])."""
    v = velo_rows.mean(0)
    anchor_t = rec.ts[anchor_idx] / 1e6
    base = boxes_shared[anchor_idx]
    out_boxes, out_scores = [], []
    p0 = poses[rec.ts[0]]
    for i, t in enumerate(target_ts):
        b = base.copy()
        dt = t / 1e6 - anchor_t
        b[:2] += v[:2] * dt
        # shared frame (first pose) -> this frame's ego
        ego = pose_transform_boxes(b[None], p0[None],
                                   np.linalg.inv(poses[t]))[0]
        out_boxes.append(ego)
        out_scores.append(rec.scores[anchor_idx]
                          * score_multiplier ** (i + 1))
    return np.stack(out_boxes, 0), np.asarray(out_scores, np.float32)


def extend_record(rec: TrackletRecord, poses: dict, full_ts_list: list,
                  extend_length: int = 10, min_length: int = 10,
                  score_multiplier: float = 0.9, velo_window: int = 10,
                  extend_all: bool = False) -> TrackletRecord:
    """Backward (and optionally forward) extension of one track."""
    if len(rec) < min_length or len(rec) < 2:
        return rec
    if any(t not in poses for t in rec.ts):
        return rec
    if (rec.ts[1] - rec.ts[0]) / 1e6 > 0.5:   # frame gap guard
        return rec

    boxes_shared = shared_frame_boxes(rec, poses)
    velo = track_velocity(boxes_shared, rec.ts)
    w = min(velo_window, len(velo))

    idx = full_ts_list.index(rec.ts[0])
    back_len = idx if extend_all else min(extend_length, idx)
    back_ts = full_ts_list[idx - back_len: idx]
    back_ts = [t for t in back_ts if t in poses]
    if back_ts:
        # NOTE: the reference enumerates backward targets oldest-first and
        # decays scores by enumeration index (lidar_tracklet.py:699-700),
        # so the OLDEST extension frame gets the highest score — reproduced
        # verbatim for leaderboard parity.
        bb, bs = _extrapolate(rec, boxes_shared, velo, poses,
                              back_ts, 0, velo[:w], score_multiplier)
    else:
        bb = np.zeros((0, 7), np.float32)
        bs = np.zeros((0,), np.float32)

    fb = np.zeros((0, 7), np.float32)
    fs = np.zeros((0,), np.float32)
    fwd_ts: list = []
    if extend_all:
        ridx = full_ts_list.index(rec.ts[-1]) + 1
        fwd_ts = [t for t in full_ts_list[ridx:] if t in poses]
        if fwd_ts:
            fb, fs = _extrapolate(rec, boxes_shared, velo, poses, fwd_ts,
                                  len(rec) - 1, velo[-w:],
                                  score_multiplier)

    return dataclasses.replace(
        rec,
        boxes=np.concatenate([bb, rec.boxes, fb], 0).astype(np.float32),
        ts=list(back_ts) + list(rec.ts) + list(fwd_ts),
        scores=np.concatenate([bs, rec.scores, fs], 0),
        num_pts=None)


def extend_bin(bin_path: str, poses_pkl: str, context2ts_pkl: str,
               out_path: str, types=(1,), **kw) -> int:
    """Full ``extend_tracks.py`` workflow: bin -> tracklets -> extend ->
    bin. Returns the number of written objects."""
    from ..evalx.waymo_bin import WaymoObject, write_bin
    from .generate_tracklets import tracklets_from_bin

    with open(poses_pkl, "rb") as f:
        poses = {k: np.asarray(v, np.float64)
                 for k, v in pickle.load(f).items()}
    with open(context2ts_pkl, "rb") as f:
        context2ts = pickle.load(f)

    tracklets = tracklets_from_bin(bin_path, types=types)
    objs = []
    for rec in tracklets:
        full = sorted(context2ts[rec.segment_name])
        ext = extend_record(rec, poses, full, **kw)
        for box, score, ts in zip(ext.boxes, ext.scores, ext.ts):
            objs.append(WaymoObject(tuple(box), float(score), ext.type,
                                    ext.id, ext.segment_name, int(ts)))
    write_bin(objs, out_path)
    return len(objs)


def merge_bins(bin_paths: list, out_path: str) -> None:
    """``tools/ctrl/merge_bins.py``: concatenating serialized ``Objects``
    messages concatenates their repeated fields — a byte-level merge is a
    valid proto merge."""
    assert not os.path.exists(out_path), f"{out_path} exists"
    with open(out_path, "wb") as out:
        for p in bin_paths:
            with open(p, "rb") as f:
                out.write(f.read())


def extract_poses(info_pkls: list, idx2timestamp_pkl: str,
                  idx2contextname_pkl: str, out_dir: str) -> tuple:
    """``tools/ctrl/extract_poses.py``: kitti-format info pkls ->
    ``poses.pkl`` (ts -> ego pose [4, 4]) + ``context2timestamp.pkl``
    (segment -> sorted ts list)."""
    with open(idx2timestamp_pkl, "rb") as f:
        idx2ts = pickle.load(f)
    with open(idx2contextname_pkl, "rb") as f:
        idx2ctx = pickle.load(f)

    pose_dict = {}
    context2ts = defaultdict(list)
    for path in info_pkls:
        with open(path, "rb") as f:
            infos = pickle.load(f)
        for info in infos:
            idx_str = os.path.basename(
                info["point_cloud"]["velodyne_path"]).split(".")[0]
            ts = idx2ts[idx_str]
            context2ts[idx2ctx[idx_str]].append(ts)
            pose_dict[ts] = np.asarray(info["pose"], np.float64)
    context2ts = {k: sorted(v) for k, v in context2ts.items()}

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "poses.pkl"), "wb") as f:
        pickle.dump(pose_dict, f)
    with open(os.path.join(out_dir, "context2timestamp.pkl"), "wb") as f:
        pickle.dump(dict(context2ts), f)
    return pose_dict, dict(context2ts)
