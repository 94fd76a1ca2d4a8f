"""GT-database sampling ("ObjectSample" / copy-paste augmentation): a copy
of the JAX package's ``data/dbsampler.py`` (the port imports nothing of
that package), draw for draw the same with the same ``RandomState``.

Rebuild of the reference's ``DataBaseSampler`` + ``ObjectSample`` pipeline
stage (``datasets/pipelines/dbsampler.py:1-324``,
``datasets/pipelines/transforms_3d.py`` ObjectSample): rare-class GT boxes
and their interior points are pasted into training frames, collision-checked
in BEV against the frame's own GT and against each other.

Host-side numpy by design — augmentation runs in the dataloader, never on
the card — and the database is built directly from the training
frames instead of a pre-dumped ``dbinfos`` pkl + ``.bin`` directory, so no
separate create-data step is needed (the reference format can still be
mirrored by pickling ``GTDatabase.entries``).
"""
from __future__ import annotations

import os

import numpy as np

from . import np_geometry as npg


def points_in_box_host(points_xyz: np.ndarray, box: np.ndarray,
                       margin: float = 0.0) -> np.ndarray:
    """Boolean mask of points inside one [x, y, z_bottom, w, l, h, yaw]
    box (host-side counterpart of core.boxes.points_in_boxes)."""
    local = npg.rotate_z(points_xyz - box[None, :3]
                         - np.array([0.0, 0.0, box[5] / 2.0]), -box[6])
    half = box[3:6] / 2.0 + margin
    return np.all(np.abs(local) <= half[None], axis=-1)


class GTDatabase:
    """Per-class store of (box, interior points) crops.

    ``entries[label] = list[(box [7], points [N, C])]`` with the points
    expressed relative to the box center (x, y at box center, z at bottom)
    and yaw-aligned, so a crop can be re-posed anywhere.
    """

    def __init__(self, entries: dict[int, list] | None = None):
        self.entries = entries if entries is not None else {}

    @classmethod
    def build_from_frames(cls, dataset, min_points: int = 8,
                          max_frames: int | None = None) -> "GTDatabase":
        """Scan a FrameDataset's GT and collect every box with at least
        ``min_points`` interior points (reference
        ``create_groundtruth_database`` semantics)."""
        rng = np.random.RandomState(0)
        entries: dict[int, list] = {}
        n = len(dataset) if max_frames is None else min(max_frames,
                                                        len(dataset))
        for i in range(n):
            s = dataset.build_sample(i, rng)
            pts = np.asarray(s["points"])[np.asarray(s["points_mask"])]
            gv = np.asarray(s["gt_valid"])
            for box, lab in zip(np.asarray(s["gt_boxes"])[gv],
                                np.asarray(s["gt_labels"])[gv]):
                inside = points_in_box_host(pts[:, :3], box)
                if int(inside.sum()) < min_points:
                    continue
                crop = pts[inside].copy()
                crop[:, :3] = npg.rotate_z(
                    crop[:, :3] - box[None, :3], -box[6])
                entries.setdefault(int(lab), []).append(
                    (box.copy(), crop))
        return cls(entries)

    def __len__(self):
        return sum(len(v) for v in self.entries.values())

    # ------------------------------------------------------------- cache
    def save(self, path: str) -> None:
        """Pickle the database (reference ``create_groundtruth_database``
        writes <root>/waymo_dbinfos_train.pkl once; rebuilding per run is
        wasteful at dataset scale)."""
        import pickle
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self.entries, f)

    @classmethod
    def load(cls, path: str) -> "GTDatabase":
        import pickle
        with open(path, "rb") as f:
            return cls(pickle.load(f))

    @classmethod
    def build_or_load(cls, dataset, cache_path: str | None = None,
                      min_points: int = 8,
                      max_frames: int | None = None) -> "GTDatabase":
        """Load from ``cache_path`` when present, else build and cache."""
        if cache_path and os.path.exists(cache_path):
            return cls.load(cache_path)
        db = cls.build_from_frames(dataset, min_points=min_points,
                                   max_frames=max_frames)
        if cache_path:
            db.save(cache_path)
        return db


class DBSampler:
    """Samples crops from a GTDatabase into a frame.

    ``sample_groups`` maps class label -> how many pasted objects to aim
    for per frame (reference ``sample_groups`` config). Candidates whose
    BEV box overlaps the frame's GT or an earlier-accepted sample are
    rejected (the reference's ``box_collision_test``).
    """

    def __init__(self, db: GTDatabase, sample_groups: dict[int, int],
                 seed: int = 0):
        self.db = db
        self.groups = dict(sample_groups)
        self.rng = np.random.RandomState(seed)

    def sample(self, gt_boxes: np.ndarray, gt_labels: np.ndarray):
        """-> (boxes [S, 7], labels [S], points [M, C]); S may be 0."""
        placed = [b for b in np.asarray(gt_boxes)]
        out_boxes, out_labels, out_points = [], [], []
        for lab, want in self.groups.items():
            pool = self.db.entries.get(int(lab), [])
            if not pool:
                continue
            have = int(np.sum(np.asarray(gt_labels) == lab))
            need = max(0, want - have)
            picks = self.rng.permutation(len(pool))[:2 * need]
            taken = 0
            for pi in picks:
                if taken >= need:
                    break
                box, crop = pool[pi]
                if placed:
                    others = np.stack(placed, 0)
                    iou = npg.aligned_iou_3d(
                        np.repeat(box[None], len(others), 0), others)
                    if np.any(iou > 1e-4):
                        continue
                pts = crop.copy()
                pts[:, :3] = npg.rotate_z(pts[:, :3], box[6]) + box[None, :3]
                placed.append(box)
                out_boxes.append(box)
                out_labels.append(lab)
                out_points.append(pts)
                taken += 1
        if not out_boxes:
            c = 5
            return (np.zeros((0, 7), np.float32),
                    np.zeros((0,), np.int32),
                    np.zeros((0, c), np.float32))
        return (np.stack(out_boxes, 0).astype(np.float32),
                np.asarray(out_labels, np.int32),
                np.concatenate(out_points, 0).astype(np.float32))


def apply_db_sample(sample: dict, sampler: DBSampler) -> dict:
    """Paste sampled objects into a padded frame sample (the dict layout
    FrameDataset.build_sample returns), keeping shapes static."""
    gv = np.asarray(sample["gt_valid"])
    boxes, labels, pts = sampler.sample(sample["gt_boxes"][gv],
                                        sample["gt_labels"][gv])
    if len(boxes) == 0:
        return sample
    out = dict(sample)
    # append GT up to the static budget
    gt_boxes = sample["gt_boxes"].copy()
    gt_labels = sample["gt_labels"].copy()
    gt_valid = sample["gt_valid"].copy()
    n0 = int(gv.sum())
    m = min(len(boxes), len(gt_boxes) - n0)
    gt_boxes[n0:n0 + m] = boxes[:m]
    gt_labels[n0:n0 + m] = labels[:m]
    gt_valid[n0:n0 + m] = True
    out["gt_boxes"], out["gt_labels"], out["gt_valid"] = (
        gt_boxes, gt_labels, gt_valid)
    # splice points into the padded buffer (evict tail padding first)
    points = sample["points"].copy()
    mask = sample["points_mask"].copy()
    p0 = int(mask.sum())
    room = len(points) - p0
    k = min(len(pts), room)
    c = min(points.shape[1], pts.shape[1])
    points[p0:p0 + k, :c] = pts[:k, :c]
    mask[p0:p0 + k] = True
    out["points"], out["points_mask"] = points, mask
    return out
