"""End-to-end OcOccNet / CTRL evaluation (counterpart of the JAX package's
``evalx/evaluator.py``): inference over a test ``TrackletDataset``, box
writeback to per-frame ego coordinates, the Waymo ``.bin`` and the native
metrics, occupancy IoU (and its point-aggregation baseline), and the dump
of predicted occupancy.

Tracklets have variable length at test (up to about 200 frames). Each is
padded to a length bucket: torch needs no static shapes, but the bucket
sets the packed layout's point budget (``models/ococcnet.py``), so it
decides which points the model keeps, and it groups the tracklets into
batches.

Under a process group (``parallel/multihost.py``) the tracklets go
round-robin by rank, as in the JAX package's multi-host run: each rank
writes ``results.shard{rank}.bin``, and after a barrier rank 0
byte-concatenates the shards (a valid merge of the proto stream) into
``results.bin`` and alone runs the Waymo metrics. Every rank still builds
every sample, so that the one ``RandomState`` of the evaluation draws the
one-process run's samples. The occupancy accumulators are reduced across
the ranks: each rank's per-tracklet terms are gathered and added in
tracklet order, so the metrics of any rank count equal one process's. (The
JAX package rebuilds its metrics from the rank's own accumulator and
reduces only ``occ/overall_iou``, dropping ``occ_baseline``.)
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..configs.ococcnet_config import OcOccNetConfig
from ..core import boxes as box_ops
from ..data.tracklet import TrackletBatch
from ..data.tracklet_dataset import TrackletDataset, pose_transform_boxes
from ..models.ococcnet import OcOccNetWithLoss
from ..ops import roi_pool as rp
from ..parallel.multihost import process_allgather, rank, sync_hosts, \
    world_size
from ..utils.device import resolve_device
from . import occ_iou as occ_iou_mod
from . import online_tuning as ot
from .tta import predict_tta
from .waymo_bin import WaymoObject, tracklets_to_objects, write_bin
from .waymo_metrics import compute_metrics

LENGTH_BUCKETS = (32, 64, 128, 256)
MAX_OCC_QUERIES = 16384
# frames per occupancy decode in save_occ
SAVE_OCC_CHUNK = 16


class _Terms:
    """An accumulator's stand-in: records each ``add_tracklet`` call's
    arguments under the tracklet's index, to be gathered across the ranks
    and added in index order."""

    def __init__(self):
        self.index = None
        self.rows = []

    def add_tracklet(self, *args):
        self.rows.append((self.index, args))


def _reduce(terms: list, acc) -> None:
    """Every rank's recorded terms (``_Terms.rows``), in tracklet order,
    into ``acc``."""
    rows = [r for part in (process_allgather(terms) if world_size() > 1
                           else [terms]) for r in part]
    for _, args in sorted(rows, key=lambda r: r[0]):
        acc.add_tracklet(*args)


def pad_to_bucket(sample: dict, cfg: OcOccNetConfig) -> tuple[dict, int]:
    """Pad a variable-length eval sample to its length bucket by repeating
    the last frame. Tracklets longer than the largest bucket get a bucket
    rounded up to the next multiple of 64 (no frame is dropped)."""
    T = sample["rois"].shape[0]
    L = next((b for b in LENGTH_BUCKETS if b >= T),
             ((T + 63) // 64) * 64)
    if T == L:
        return sample, T
    pad = L - T

    def pad_frames(x, value=None):
        rep = np.repeat(x[-1:], pad, axis=0) if value is None else \
            np.full((pad,) + x.shape[1:], value, x.dtype)
        return np.concatenate([x, rep], 0)

    out = dict(sample)
    out["points"] = pad_frames(sample["points"])
    out["points_mask"] = pad_frames(sample["points_mask"], value=False)
    out["rois"] = pad_frames(sample["rois"])
    out["roi_scores"] = pad_frames(sample["roi_scores"])
    out["gt_boxes"] = pad_frames(sample["gt_boxes"])
    out["gt_valid"] = pad_frames(sample["gt_valid"], value=False)
    last = sample["frame_inds"][-1]
    out["frame_inds"] = np.concatenate(
        [sample["frame_inds"], last + 1 + np.arange(pad, dtype=np.int32)])
    return out, T


class Evaluator:
    def __init__(self, model: OcOccNetWithLoss, dataset: TrackletDataset,
                 cfg: OcOccNetConfig, occ_label_thresh: float | None = None,
                 online_tuning_iters: int = 0,
                 online_tuning_lr: float = 0.01, tta: bool = False,
                 device="cuda"):
        """``model`` holds the weights and moves to ``device`` (``cuda``
        unless the caller asks for the CPU).

        ``online_tuning_iters > 0`` fits each RoI's shape latent to the
        occupancy observed from its own points before decoding (the
        reference's ``test_cfg.online_tuning``). ``tta=True`` runs the
        double-flip test-time augmentation: four flip variants per batch,
        predictions flipped back and merged."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.ds = dataset
        self.cfg = cfg
        self.tta = tta
        self.occ_label_thresh = (occ_label_thresh if occ_label_thresh
                                 is not None else cfg.occ_label_thresh)
        self.online_tuning_iters = online_tuning_iters
        self.online_tuning_lr = online_tuning_lr

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _predict(self, batch: TrackletBatch) -> dict:
        with torch.no_grad():
            if self.tta:
                return predict_tta(self.model.predict, batch)
            return self.model.predict(batch)

    def _maybe_tune(self, pred: dict, padded: dict) -> dict:
        """Adam-fit each RoI's shape latent to the occupancy observed from
        its own pooled points (online test-time tuning)."""
        if self.online_tuning_iters <= 0:
            return pred
        cfg = self.cfg
        rois = self._tensor(padded["rois"])
        pts = self._tensor(padded["points"])
        with torch.no_grad():
            pool = rp.roi_pool(pts[..., :3], self._tensor(
                padded["points_mask"]), rois, cfg.extra_wlh)
            K = min(512, pool.local_xyz.shape[-2])
            queries = rp.quantize_to_voxel_centers(
                pool.local_xyz[..., :K, :], rois[..., 3:6],
                cfg.ae_voxel_size)
            labels = ot.observation_targets(
                pool.local_xyz, pool.mask, rois[..., 3:6], cfg.ae_voxel_size,
                queries)
            msk = pool.mask[..., :K].float()
        tuned = ot.tune_latent(self.model.decode_occ_queries,
                               pred["shape_latent"][0], queries, labels, msk,
                               self.online_tuning_iters,
                               self.online_tuning_lr)
        return dict(pred, shape_latent=tuned[None])

    def run(self, out_dir: str, max_tracklets: int | None = None,
            eval_occ: bool = True, eval_waymo: bool = True,
            gt_bin: str | None = None, save_occ_root: str | None = None,
            batch_size: int = 1, eval_occ_baseline: bool = False) -> dict:
        """Evaluate the first ``max_tracklets`` tracklets (default all).
        ``batch_size > 1`` groups tracklets of one length bucket into one
        call (the last group of a bucket is filled up with its last
        tracklet). ``eval_occ_baseline`` also scores the point-aggregation
        baseline through the same accumulator, beside the model's. Under a
        process group each rank evaluates every ``world``-th tracklet from
        its rank on (module docstring); every rank returns the occupancy
        metrics, rank 0 alone the Waymo ones."""
        os.makedirs(out_dir, exist_ok=True)
        rng = np.random.RandomState(0)
        world, me = world_size(), rank()
        terms = _Terms()
        terms_base = _Terms() if eval_occ_baseline else None
        out_tracklets = []
        n = len(self.ds) if max_tracklets is None else min(
            max_tracklets, len(self.ds))

        # every sample from one RandomState, in index order; this rank's
        # tracklets round-robin
        prepared = []
        for i in range(n):
            sample = self.ds.build_sample(i, rng)
            if i % world != me:
                continue
            padded, T = pad_to_bucket(sample, self.cfg)
            prepared.append((i, sample, padded, T))
        by_bucket: dict = {}
        for item in prepared:
            by_bucket.setdefault(item[2]["rois"].shape[0], []).append(item)

        preds: dict = {}
        for items in by_bucket.values():
            for beg in range(0, len(items), batch_size):
                chunk = items[beg:beg + batch_size]
                pad_n = batch_size - len(chunk)
                batch = TrackletBatch(**{
                    k: self._tensor(np.stack([it[2][k] for it in chunk]
                                             + [chunk[-1][2][k]] * pad_n, 0))
                    for k in TrackletBatch._fields})
                out = self._predict(batch)
                for j, it in enumerate(chunk):
                    preds[it[0]] = {k: v[j:j + 1] for k, v in out.items()}

        for i, sample, padded, T in prepared:
            rec = self.ds.records[i]
            pred = self._maybe_tune(preds[i], padded)

            boxes = pred["boxes"][0, :T].cpu().numpy()
            scores = pred["scores"][0, :T].cpu().numpy()
            nonempty = pred["nonempty"][0, :T].cpu().numpy()
            # keep the proposal where the RoI pooled no points
            boxes = np.where(nonempty[:, None], boxes, padded["rois"][:T])
            scores = np.where(nonempty, scores, padded["roi_scores"][:T])

            # writeback: shared frame -> per-frame ego
            ts = sample["meta"]["ts"][:T]
            poses = np.stack([self.ds.poses[t] for t in ts], 0)
            center_pose = poses[len(poses) // 2]
            ego_boxes = np.stack([
                pose_transform_boxes(boxes[j:j + 1], center_pose[None],
                                     np.linalg.inv(poses[j]))[0]
                for j in range(T)], 0)
            out_tracklets.append(dict(
                segment_name=rec.segment_name, id=rec.id,
                waymo_type=rec.type, boxes=ego_boxes, scores=scores, ts=ts))

            if eval_occ:
                terms.index = i
                if terms_base is not None:
                    terms_base.index = i
                self._eval_occ_one(i, rec, padded, pred, T, terms,
                                   acc_base=terms_base)
            if save_occ_root is not None:
                self.save_occ(save_occ_root, rec,
                              dict(sample, rois=padded["rois"]), pred, T)

        bin_path = os.path.join(out_dir, "results.bin")
        write_bin(tracklets_to_objects(out_tracklets, self.ds.class_names),
                  bin_path if world == 1
                  else os.path.join(out_dir, f"results.shard{me}.bin"))
        if world > 1:
            sync_hosts("eval_shards")
            if me == 0:
                with open(bin_path, "wb") as out:
                    for r in range(world):
                        with open(os.path.join(
                                out_dir, f"results.shard{r}.bin"), "rb") as f:
                            out.write(f.read())
            sync_hosts("eval_merge")
        acc = occ_iou_mod.OccIoUAccumulator()
        _reduce(terms.rows, acc)
        metrics = acc.summary() if eval_occ else {}
        if terms_base is not None:
            acc_base = occ_iou_mod.OccIoUAccumulator()
            _reduce(terms_base.rows, acc_base)
            metrics.update(acc_base.summary(prefix="occ_baseline"))
        metrics["num_tracklets"] = n
        metrics["results_bin"] = bin_path

        if eval_waymo and me == 0:
            gt_path = gt_bin or os.path.join(out_dir, "gt.bin")
            if gt_bin is None:
                self.write_gt_bin(gt_path, max_tracklets=n)
            ap = compute_metrics(bin_path, gt_path)
            metrics.update({k: v for k, v in ap.items() if k != "_raw"})
        return metrics

    def write_gt_bin(self, path: str, max_tracklets: int | None = None):
        """The GT ``.bin`` from the dataset's selected candidate tracklets
        (per-frame ego boxes), restricted to the evaluated tracks."""
        objs = []
        n = len(self.ds) if max_tracklets is None else min(
            max_tracklets, len(self.ds))
        for i in range(n):
            rec = self.ds.records[i]
            ci = self.ds.select_candidate(rec, self.ds.candidates[i])
            if ci < 0:
                continue
            gt = self.ds.candidates[i][ci]
            npts = (gt.num_pts if gt.num_pts is not None
                    else [50] * len(gt))
            for box, ts, np_ in zip(gt.boxes, gt.ts, npts):
                objs.append(WaymoObject(
                    tuple(box), 1.0, int(gt.type), gt.id, gt.segment_name,
                    int(ts), num_lidar_points=int(np_), difficulty=1))
        write_bin(objs, path)

    def save_occ(self, out_root: str, rec, sample: dict, pred: dict, T: int,
                 max_queries: int = 8192):
        """Dump the predicted occupancy of each frame as
        ``<out>/<segment>/<ts>/<type>_<id>.bin``, float32 [K, 4] (xyz in
        the shared frame and the frame's score): every voxel centre of the
        RoI's grid (at most ``max_queries``) whose probability exceeds
        ``occ_pos_thresh``, decoded 16 frames at a time."""
        latent = pred["shape_latent"][0]                 # [L, D] (padded)
        L = latent.shape[0]
        rois = np.asarray(sample["rois"])[:L]
        ts = sample["meta"]["ts"][:T]
        scores = pred["scores"][0, :T].cpu().numpy()

        counts = np.zeros(L, np.int64)
        grids = []
        for j in range(T):
            centers = occ_iou_mod.dense_voxel_centers(
                rois[j, 3:6], self.cfg.ae_voxel_size)[:max_queries]
            grids.append(centers)
            counts[j] = len(centers)
        kq = int(counts.max())
        queries = np.zeros((L, kq, 3), np.float32)
        for j, c in enumerate(grids):
            queries[j, :len(c)] = c
        queries = self._tensor(queries)
        rois_t = self._tensor(rois)
        probs, egos = [], []
        with torch.no_grad():
            for beg in range(0, L, SAVE_OCC_CHUNK):
                sl = slice(beg, beg + SAVE_OCC_CHUNK)
                probs.append(torch.sigmoid(self.model.decode_occ_queries(
                    latent[sl], queries[sl])))
                egos.append(box_ops.local_to_global(queries[sl],
                                                    rois_t[sl]))
        prob = torch.cat(probs).cpu().numpy()
        ego = torch.cat(egos).cpu().numpy()
        for j in range(T):
            keep = prob[j, :counts[j]] > self.cfg.occ_pos_thresh
            if not keep.any():
                continue
            out = np.concatenate(
                [ego[j, :counts[j]][keep],
                 np.full((int(keep.sum()), 1), scores[j], np.float32)], -1)
            d = os.path.join(out_root, rec.segment_name, str(ts[j]))
            os.makedirs(d, exist_ok=True)
            out.astype(np.float32).tofile(
                os.path.join(d, f"{rec.type}_{rec.id}.bin"))

    def _eval_occ_one(self, i, rec, padded, pred, T, acc, acc_base=None):
        if self.ds.occ_anno_root is None:
            return
        ci = self.ds.select_candidate(rec, self.ds.candidates[i])
        if ci < 0:
            return
        gt_rec = self.ds.candidates[i][ci]
        occ_path = os.path.join(self.ds.occ_anno_root, gt_rec.segment_name,
                                f"{gt_rec.id}.npz")
        if not os.path.exists(occ_path):
            return
        if padded["occ_score"] < self.occ_label_thresh:
            return
        pts, lab, msk = occ_iou_mod.load_full_occ_queries(
            occ_path, self.cfg.ae_voxel_size, MAX_OCC_QUERIES)
        # the refined boxes' frame is not used: the reference decodes in
        # the original RoIs' frame at test
        inter, union = occ_iou_mod.occ_iou_per_frame(
            self.model.decode_occ_queries, pred["shape_latent"][0],
            self._tensor(padded["rois"]), self._tensor(padded["gt_boxes"]),
            self._tensor(padded["gt_valid"]), self._tensor(pts),
            self._tensor(lab), self._tensor(msk), self.cfg.occ_pos_thresh)
        gt_vols = padded["gt_boxes"][:, 3:6].prod(-1)
        valid = padded["gt_valid"].copy()
        valid[T:] = False
        acc.add_tracklet(inter.cpu().numpy(), union.cpu().numpy(), gt_vols,
                         valid)
        if acc_base is not None:
            b_inter, b_union = occ_iou_mod.occ_baseline_tracklet(
                padded["points"], padded["points_mask"], padded["rois"],
                padded["gt_boxes"], valid, pts[msk], lab[msk], msk[msk],
                self.cfg.ae_voxel_size)
            acc_base.add_tracklet(b_inter, b_union, gt_vols, valid)
