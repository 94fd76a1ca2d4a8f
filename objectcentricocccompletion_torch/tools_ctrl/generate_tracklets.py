"""Stage-1 -> stage-2 bridge: build the tracklet dataset from detection/
tracking ``.bin`` results (a copy of the JAX package's
``tools_ctrl/generate_tracklets.py``; the port imports nothing of that
package).

Rebuild of the ``tools/ctrl`` data-prep pipeline (SURVEY.md §2.3):
  * ``generate_tracklets`` (``tools/ctrl/utils.py:18-60``): group bin
    objects by (segment, object id) into per-frame ego-box tracklets
    (waymo box -> LiDAR layout: heading = wrap(-h - pi/2), z -= height/2),
  * ``generate_track_input`` (``tools/ctrl/generate_track_input.py:20-69``):
    for each tracklet frame, crop the frame's points inside the (enlarged)
    box and save the per-tracklet npy the tracklet dataset reads,
  * ``generate_candidates`` (``tools/ctrl/generate_candidates.py:20-71``):
    assign GT tracklets as candidates of each predicted tracklet when their
    best per-timestamp aligned IoU exceeds a threshold,
  * ``extract_poses``: dump the ts -> ego pose dict.

Together with the detectors and the evaluator's ``.bin`` writer this closes
the loop: detector -> tracker bins -> tracklet pkls + point npys ->
OcOccNet/CTRL training.
"""
from __future__ import annotations

import math
import os
import pickle
from collections import defaultdict

import numpy as np

from ..data import np_geometry as npg
from ..data.tracklet_dataset import TrackletRecord
from ..evalx.waymo_bin import read_bin


def _wrap(h):
    while h < -math.pi:
        h += 2 * math.pi
    while h > math.pi:
        h -= 2 * math.pi
    return h


def tracklets_from_bin(bin_path: str, types=(1,)) -> list[TrackletRecord]:
    """Group bin objects into per-frame ego-box TrackletRecords."""
    groups: dict = defaultdict(list)
    for rec in read_bin(bin_path):
        if rec.get("type") not in types:
            continue
        b = rec["box"]
        # waymo Box fields: 1 cx, 2 cy, 3 cz(gravity), 4 w, 5 l, 6 h,
        # 7 heading -> our (x, y, z_bottom, w, l, h, yaw)
        yaw = _wrap(-b[7] - 0.5 * math.pi)
        box = np.asarray([b[1], b[2], b[3] - b[6] / 2, b[4], b[5], b[6],
                          yaw], np.float32)
        key = (rec["context_name"], rec["id"], rec["type"])
        groups[key].append((rec["timestamp"], box, rec.get("score", 1.0)))

    out = []
    for (seg, oid, typ), items in groups.items():
        items.sort(key=lambda x: x[0])
        ts = [int(i[0]) for i in items]
        boxes = np.stack([i[1] for i in items], 0)
        scores = np.asarray([i[2] for i in items], np.float32)
        out.append(TrackletRecord(seg, oid, int(typ), False, boxes, ts,
                                  scores, None))
    return out


def extract_track_points(tracklets: list[TrackletRecord], get_points,
                         out_db_dir: str, extra_wlh=(1.0, 1.0, 1.0),
                         max_points_per_frame: int = 1024,
                         seed: int = 0) -> None:
    """Save per-tracklet per-frame in-box point npys
    (``<db>/<segment>--<id>.npy``). ``get_points(segment, ts) -> [N, >=5]``
    frame points in ego coords."""
    rng = np.random.RandomState(seed)
    os.makedirs(out_db_dir, exist_ok=True)
    for trk in tracklets:
        frames = []
        num_pts = []
        for box, ts in zip(trk.boxes, trk.ts):
            pts = np.asarray(get_points(trk.segment_name, ts), np.float32)
            d = pts[:, :3] - box[:3]
            c, s = np.cos(-box[6]), np.sin(-box[6])
            lx = d[:, 0] * c + d[:, 1] * s
            ly = -d[:, 0] * s + d[:, 1] * c
            lz = d[:, 2] - box[5] / 2
            half = box[3:6] / 2 + np.asarray(extra_wlh) / 2
            m = (np.abs(lx) <= half[0]) & (np.abs(ly) <= half[1]) \
                & (np.abs(lz) <= half[2])
            sel = pts[m]
            if len(sel) > max_points_per_frame:
                sel = sel[rng.permutation(len(sel))[:max_points_per_frame]]
            if sel.shape[1] < 6:
                sel = np.pad(sel, ((0, 0), (0, 6 - sel.shape[1])))
            frames.append(sel.astype(np.float32))
            num_pts.append(len(sel))
        trk.num_pts = np.asarray(num_pts)
        np.save(os.path.join(out_db_dir,
                             f"{trk.segment_name}--{trk.id}.npy"),
                np.asarray(frames, dtype=object), allow_pickle=True)


def assign_candidates(pred: list[TrackletRecord], gt: list[TrackletRecord],
                      affinity_thresh: float = 0.1) -> list[list]:
    """Per predicted tracklet, the GT tracklets whose best per-timestamp
    aligned IoU exceeds ``affinity_thresh``
    (``generate_candidates.tracklet_assign``)."""
    by_seg = defaultdict(list)
    for g in gt:
        by_seg[g.segment_name].append(g)
    out = []
    for p in pred:
        cands = []
        p_idx = {t: i for i, t in enumerate(p.ts)}
        for g in by_seg.get(p.segment_name, []):
            common = [(p_idx[t], j) for j, t in enumerate(g.ts)
                      if t in p_idx]
            if not common:
                continue
            ii = np.asarray([c[0] for c in common])
            jj = np.asarray([c[1] for c in common])
            ious = npg.aligned_iou_3d(p.boxes[ii], g.boxes[jj])
            if ious.max() > affinity_thresh:
                cands.append(g)
        out.append(cands)
    return out


def write_tracklet_dataset(pred_bin: str, gt_bin: str, get_points,
                           out_dir: str, poses: dict,
                           types=(1,)) -> dict:
    """End-to-end data prep: bins + frame points -> the pkl/npy layout the
    TrackletDataset reads. Returns the path dict for TrackletDataset."""
    os.makedirs(out_dir, exist_ok=True)
    pred = tracklets_from_bin(pred_bin, types)
    gt = tracklets_from_bin(gt_bin, types)

    prop_path = os.path.join(out_dir, "proposals.pkl")
    db_dir = prop_path.replace(".pkl", "_database")
    extract_track_points(pred, get_points, db_dir)
    cands = assign_candidates(pred, gt)

    with open(prop_path, "wb") as f:
        pickle.dump([p.to_dump() for p in pred], f)
    with open(os.path.join(out_dir, "gt_candidates.pkl"), "wb") as f:
        pickle.dump([[c.to_dump() for c in cl] for cl in cands], f)
    with open(os.path.join(out_dir, "poses.pkl"), "wb") as f:
        pickle.dump(poses, f)
    return dict(proposals_file=prop_path,
                gt_candidates_file=os.path.join(out_dir,
                                                "gt_candidates.pkl"),
                pose_file=os.path.join(out_dir, "poses.pkl"))
