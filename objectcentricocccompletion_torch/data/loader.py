"""Tracklet batching and a reference-format synthetic dataset writer
(counterpart of the JAX package's ``data/loader.py``: ``collate``,
``TrainLoader``, ``make_loader``, ``ThreadPrefetcher`` and
``write_synthetic_dataset``, which writes the same files).

``collate`` stacks numpy samples into a ``TrackletBatch`` of CPU tensors;
the training loop moves it to the device. Worker processes
(``PrefetchLoader``) are not ported yet: the CLI refuses
``--loader-workers`` above 0.
"""
from __future__ import annotations

import os
import pickle
import queue
import threading

import numpy as np
import torch

from .tracklet import TrackletBatch
from .tracklet_dataset import TrackletDataset


def collate(samples: list[dict]) -> TrackletBatch:
    """Stack the samples' arrays into CPU tensors."""
    def stack(key):
        return torch.from_numpy(np.stack([s[key] for s in samples], 0))

    return TrackletBatch(*(stack(k) for k in TrackletBatch._fields))


class TrainLoader:
    """Endless shuffled batches of a ``TrackletDataset``: a new permutation
    of the dataset (from ``numpy.random.RandomState(seed)``) whenever the
    last one runs out, taken from its end; the same state feeds the
    samples' own randomness. The JAX package's loader on one host, draw for
    draw (its ``num_shards`` / ``shard_id`` serve the multi-host launch,
    which is not ported)."""

    def __init__(self, dataset: TrackletDataset, batch_size: int,
                 seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self._order = []

    def __iter__(self):
        return self

    def __next__(self) -> TrackletBatch:
        samples = []
        while len(samples) < self.batch_size:
            if not self._order:
                self._order = list(self.rng.permutation(len(self.ds)))
            idx = self._order.pop()
            samples.append(self.ds.build_sample(idx, self.rng))
        return collate(samples)


def make_loader(dataset: TrackletDataset, batch_size: int, seed: int = 0
                ) -> TrainLoader:
    """The serial ``TrainLoader`` (the JAX package's ``make_loader`` with no
    worker processes)."""
    return TrainLoader(dataset, batch_size, seed=seed)


def write_synthetic_dataset(root: str, num_tracklets: int = 4,
                            track_len: int = 40, seed: int = 0,
                            voxel_size: float = 0.2,
                            obj_type: int = 1) -> dict:
    """Emit a tiny dataset in the reference's exact on-disk layout:
    proposals pkl + candidates pkl + poses pkl + points _database/ + occ npz
    tree. Returns the paths dict accepted by TrackletDataset."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    seg = "segment-0000"
    prop_path = os.path.join(root, "proposals.pkl")
    db_dir = os.path.join(root, "proposals_database")
    occ_root = os.path.join(root, "occ_gt")
    os.makedirs(db_dir, exist_ok=True)
    os.makedirs(os.path.join(occ_root, seg), exist_ok=True)

    proposals, candidates, poses = [], [], {}
    for k in range(num_tracklets):
        tid = f"trk_{k}"
        T = track_len
        ts = [int(1e9) + k * 100000 * 1000 + i * 100000 for i in range(T)]
        # ego poses: slowly moving/rotating frames
        pose_list = []
        for i in range(T):
            a = 0.01 * i + 0.1 * k
            c, s = np.cos(a), np.sin(a)
            p = np.eye(4)
            p[:2, :2] = [[c, -s], [s, c]]
            p[:3, 3] = [0.5 * i, 0.1 * i, 0.0]
            pose_list.append(p)
            poses[ts[i]] = p.astype(np.float64)

        # GT boxes in world; proposal = noisy GT, both stored in ego frames.
        # Keep z inside the point-range filter (POINT_RANGE z in
        # [-3.99, 7.99]) so pose-transformed points survive the pipeline.
        size = np.abs(rng.normal([4.5, 2.0, 1.7], 0.3))
        world_ctr = np.concatenate([rng.uniform(-10, 10, 2),
                                    rng.uniform(-1.5, 0.5, 1)])
        world_yaw = rng.uniform(-np.pi, np.pi)
        gt_boxes, pd_boxes = [], []
        for i in range(T):
            wc = world_ctr + np.array([0.3 * i, 0.1 * i, 0.0])
            inv = np.linalg.inv(pose_list[i])
            ec = inv[:3, :3] @ wc + inv[:3, 3]
            # yaw in ego: heading (sin,cos) rotated by inv rotation
            h = np.array([np.sin(world_yaw), np.cos(world_yaw), 0.0])
            he = inv[:3, :3] @ h
            eyaw = np.arctan2(he[0], he[1])
            gt = np.concatenate([ec, size, [eyaw]]).astype(np.float32)
            gt_boxes.append(gt.reshape(1, 7))
            noise = np.concatenate([rng.uniform(-0.1, 0.1, 3),
                                    rng.uniform(-0.05, 0.05, 3),
                                    rng.uniform(-0.05, 0.05, 1)])
            pd_boxes.append((gt + noise).astype(np.float32).reshape(1, 7))

        # per-frame points on the GT box surface (ego frame)
        pts_frames = []
        for i in range(T):
            n = rng.randint(80, 200)
            u = rng.uniform(-0.5, 0.5, (n, 3))
            face = rng.randint(0, 3, n)
            sgn = rng.choice([-0.5, 0.5], n)
            for a in range(3):
                u[face == a, a] = sgn[face == a]
            local = u * size
            b = gt_boxes[i][0]
            cy, sy = np.cos(b[6]), np.sin(b[6])
            ex = local[:, 0] * cy - local[:, 1] * sy + b[0]
            ey = local[:, 0] * sy + local[:, 1] * cy + b[1]
            ez = local[:, 2] + b[2] + size[2] / 2
            extra = rng.rand(n, 3).astype(np.float32)
            pts_frames.append(np.stack(
                [ex, ey, ez, extra[:, 0], extra[:, 1], extra[:, 2]],
                -1).astype(np.float32))
        np.save(os.path.join(db_dir, f"{seg}--{tid}.npy"),
                np.asarray(pts_frames, dtype=object), allow_pickle=True)

        num_pts = [len(p) for p in pts_frames]
        proposals.append((seg, tid, obj_type, False, pd_boxes, ts,
                          [0.9] * T, num_pts))
        gt_id = f"gt_{k}"
        candidates.append([(seg, gt_id, obj_type, False, gt_boxes, ts,
                            [1.0] * T, num_pts)])

        # occupancy grid: a solid box occupying the middle of the volume
        dims = np.maximum(np.ceil(size / voxel_size).astype(int), 1)
        occ = np.full(dims, 2, np.int32)     # free
        occ[dims[0] // 4: -dims[0] // 4 or None,
            dims[1] // 4: -dims[1] // 4 or None,
            dims[2] // 4: -dims[2] // 4 or None] = 1  # occupied core
        occ[0, 0, 0] = 0                     # one unknown voxel
        np.savez(os.path.join(occ_root, seg, f"{gt_id}.npz"), occ=occ)

    cand_path = os.path.join(root, "gt_candidates.pkl")
    pose_path = os.path.join(root, "poses.pkl")
    with open(prop_path, "wb") as f:
        pickle.dump(proposals, f)
    with open(cand_path, "wb") as f:
        pickle.dump(candidates, f)
    with open(pose_path, "wb") as f:
        pickle.dump(poses, f)
    return dict(proposals_file=prop_path, gt_candidates_file=cand_path,
                pose_file=pose_path, occ_anno_root=occ_root)


class ThreadPrefetcher:
    """Background-thread double buffering over any loader: sample building
    overlaps the device step. Both run Python under one interpreter lock,
    so where the step itself is bound by the host's launch rate the build
    thread can slow it (``PERF.md``)."""

    def __init__(self, loader, depth: int = 2):
        self._loader = loader
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()

        def run():
            while not self._stop.is_set():
                try:
                    item = next(self._loader)
                except Exception as e:       # surface in the consumer
                    self._q.put(e)
                    return
                self._q.put(item)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        """Stop the thread and wait for it: it ends after at most the one
        batch it is building, once the queue has room for it."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        if hasattr(self._loader, "close"):
            self._loader.close()
