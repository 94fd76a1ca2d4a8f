"""Offline seed boxes for FSD++ training (a copy of the JAX package's
``data/seed_store.py``): a base detector's Waymo results ``.bin`` becomes
per-frame seed boxes keyed by (segment, timestamp).

Wire boxes convert back to this framework's layout as the inverse of the
``.bin`` writer (``evalx/waymo_bin.py::encode_object``): bottom-centre z =
centre z - h / 2, yaw = -heading - pi / 2 (its own inverse).
"""
from __future__ import annotations

import pickle
from collections import defaultdict

import numpy as np

from ..evalx.waymo_bin import read_bin, wrap_heading

_WAYMO_TO_LABEL = {1: 0, 2: 1, 4: 2}   # vehicle, pedestrian, cyclist


def waymo_box_to_ours(box: dict) -> np.ndarray:
    """A wire Label.Box field dict (from ``read_bin``) -> [7] boxes of this
    framework."""
    cx, cy, cz = box.get(1, 0.0), box.get(2, 0.0), box.get(3, 0.0)
    w, l, h = box.get(4, 0.0), box.get(5, 0.0), box.get(6, 0.0)
    yaw = wrap_heading(-box.get(7, 0.0) - 0.5 * np.pi)
    return np.asarray([cx, cy, cz - h / 2, w, l, h, yaw], np.float32)


class SeedStore:
    """(segment, ts) -> padded (boxes [S, 7], labels [S], scores [S],
    valid [S]) numpy seed arrays."""

    def __init__(self, frames: dict, max_seeds: int = 128):
        self.frames = frames
        self.max_seeds = max_seeds

    @classmethod
    def from_results_bin(cls, path: str, max_seeds: int = 128,
                         score_thr: float = 0.0) -> "SeedStore":
        by_frame = defaultdict(list)
        for rec in read_bin(path):
            if rec.get("score", 0.0) < score_thr:
                continue
            key = (rec.get("context_name", ""), int(rec.get("timestamp", 0)))
            by_frame[key].append(
                (waymo_box_to_ours(rec.get("box", {})),
                 _WAYMO_TO_LABEL.get(rec.get("type", 1), 0),
                 float(rec.get("score", 0.0))))
        return cls(dict(by_frame), max_seeds)

    @classmethod
    def load(cls, path: str) -> "SeedStore":
        # a store this class saved
        with open(path, "rb") as f:
            payload = pickle.load(f)
        return cls(payload["frames"], payload["max_seeds"])

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(dict(frames=self.frames,
                             max_seeds=self.max_seeds), f)

    def get(self, segment: str, ts: int):
        S = self.max_seeds
        boxes = np.zeros((S, 7), np.float32)
        labels = np.zeros((S,), np.int32)
        scores = np.zeros((S,), np.float32)
        valid = np.zeros((S,), bool)
        items = self.frames.get((segment, int(ts)), [])
        items = sorted(items, key=lambda it: -it[2])[:S]
        for i, (b, lab, sc) in enumerate(items):
            boxes[i], labels[i], scores[i], valid[i] = b, lab, sc, True
        return boxes, labels, scores, valid
