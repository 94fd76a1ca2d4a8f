"""Host-side tracklet dataset and training pipeline, pure numpy (a copy of
the JAX package's ``data/tracklet_dataset.py``: the same samples, array for
array, from the same ``RandomState``; the port imports nothing of that
package).

Reads the reference's on-disk formats bit-compatibly
(``datasets/waymo_tracklet_dataset.py:32-230``):
  * tracklet proposals pkl — list of dump-format tuples
    ``(segment_name, id, type, in_world, [boxes [1,7]], ts_list, score_list,
    num_pts_in_boxes)`` (``lidar_tracklet.py:130-161``),
  * GT candidates pkl — per-proposal list of the same tuples,
  * poses pkl — dict ``ts -> [4,4]`` ego->world,
  * per-tracklet points ``<proposals>_database/<segment>--<id>.npy`` — object
    array of per-frame ``[Ni, 6]`` points,
  * occupancy GT ``<occ_root>/<segment>/<trk_id>.npz`` with ``occ[X,Y,Z]``
    int32 in {0 unknown, 1 occupied, 2 free}.

The pipeline fuses the reference transform chain
(``configs/ococc/ococcnet.py:183-256``): load/cap points, regularize to
reg_len, pose-transform to the middle frame, box noise, point decoration,
flips, global rot/scale/trans, range filter — and additionally performs GT
candidate selection + per-timestamp GT alignment (the reference does this
on-GPU in ``TrackletRoIHeadOCC._assign_and_sample``; moving it here makes
the device graph fully static) and balanced occupancy sampling
(``RandomSampleOccPoints``). Output is one dense ``TrackletBatch`` sample.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from collections import OrderedDict
from typing import Sequence

import numpy as np

from ..configs.ococcnet_config import OcOccNetConfig
from . import np_geometry as npg

WAYMO_TYPE_NAMES = {1: "Car", 2: "Pedestrian", 3: "Sign", 4: "Cyclist"}
POINT_RANGE = (-204.7, -204.7, -3.99, 204.7, 204.7, 7.99)
_CACHE_MISS = object()   # occ-LRU sentinel (None is a cacheable result)


@dataclasses.dataclass
class TrackletRecord:
    segment_name: str
    id: str
    type: int                     # waymo type id
    in_world: bool
    boxes: np.ndarray             # [T, 7] float32, per-frame ego coords
    ts: list                      # [T] timestamps (int)
    scores: np.ndarray            # [T] float32
    num_pts: np.ndarray | None    # [T] int

    @classmethod
    def from_dump(cls, tup) -> "TrackletRecord":
        seg, tid, typ, in_world, boxes, ts, scores, num_pts = tup
        boxes = (np.concatenate([np.asarray(b).reshape(1, -1) for b in boxes],
                                0).astype(np.float32)
                 if len(boxes) else np.zeros((0, 7), np.float32))
        return cls(seg, tid, int(typ), bool(in_world), boxes[:, :7], list(ts),
                   np.asarray(scores, np.float32),
                   None if num_pts is None else np.asarray(num_pts))

    def to_dump(self):
        return (self.segment_name, self.id, self.type, self.in_world,
                [b.reshape(1, -1) for b in self.boxes], list(self.ts),
                list(self.scores), None if self.num_pts is None
                else list(self.num_pts))

    def __len__(self):
        return len(self.ts)


def _load_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def mirror_occ_label(occ: np.ndarray) -> np.ndarray:
    """Fill unknown voxels with their x-mirrored counterpart
    (``MirrorOccLabel``, ``occ_pinelines.py:83-127``) — vehicles are
    front/back near-symmetric, so a voxel occluded on one side often has a
    known mirror."""
    mirrored = occ[::-1]
    return np.where(occ == 0, mirrored, occ)


def pose_transform_boxes(boxes: np.ndarray, src_poses: np.ndarray,
                         tgt_pose_inv: np.ndarray) -> np.ndarray:
    """Move per-frame ego boxes into a shared target frame
    (``lidar_tracklet.frame_transform``, heading via (sin, cos) vector)."""
    mm = tgt_pose_inv[None] @ src_poses  # [T, 4, 4]
    ctr_h = np.concatenate(
        [boxes[:, :3], np.ones((len(boxes), 1), boxes.dtype)], 1)
    ctr = np.einsum("tij,tj->ti", mm, ctr_h)[:, :3]
    yaw = boxes[:, 6]
    heading = np.stack([np.sin(yaw), np.cos(yaw), np.zeros_like(yaw)], -1)
    h = np.einsum("tij,tj->ti", mm[:, :3, :3], heading)
    new_yaw = np.arctan2(h[:, 0], h[:, 1])
    return np.concatenate(
        [ctr, boxes[:, 3:6], new_yaw[:, None]], 1).astype(np.float32)


def pose_transform_points(pts_xyz: np.ndarray, mm: np.ndarray) -> np.ndarray:
    """Per-frame ego points -> shared frame via ``mm = inv(center) @ pose``
    (``TrackletPoseTransform.points_frame_transform``,
    ``tracklet_pipelines.py:287-297``)."""
    return pts_xyz @ mm[:3, :3].T + mm[:3, 3]


def apply_flip(points: np.ndarray, boxes_list, horizontal: bool) -> None:
    """In-place BEV flip (``TrackletRandomFlip`` -> ``LiDARPoints.flip`` +
    ``LiDARInstance3DBoxes.flip``): horizontal mirrors y and maps
    yaw -> pi - yaw; vertical mirrors x and negates yaw."""
    if horizontal:
        points[..., 1] *= -1
        for b in boxes_list:
            b[:, 1] *= -1
            b[:, 6] = np.pi - b[:, 6]
    else:
        points[..., 0] *= -1
        for b in boxes_list:
            b[:, 0] *= -1
            b[:, 6] = -b[:, 6]


def apply_rot_scale_trans(points: np.ndarray, boxes_list, ang: float,
                          sc: float, tr: np.ndarray) -> None:
    """In-place global rotation/scale/translation
    (``TrackletGlobalRotScaleTrans``: boxes ``rotate(ang)`` while points
    ``rotate(-ang)`` — the two classes use transposed matrix conventions, so
    both reduce to the same ``x' = x c + y s, y' = y c - x s`` map; scale
    multiplies centers, sizes and points; translation adds last)."""
    c, s = np.cos(ang), np.sin(ang)
    # scalar-angle rotate_z, in place (the generic helper builds full-size
    # angle/cos/sin arrays — measured 15% of build time)
    x = points[..., 0].copy()
    y = points[..., 1]
    points[..., 0] = x * c + y * s
    points[..., 1] = y * c - x * s
    for b in boxes_list:
        bx = b[:, 0].copy()
        by = b[:, 1]
        b[:, 0] = bx * c + by * s
        b[:, 1] = by * c - bx * s
        b[:, 6] += ang
        b[:, :6] *= sc
        b[:, :3] += tr
    points[..., :3] *= sc
    points[..., :3] += tr


class TrackletDataset:
    """Reference-format tracklet dataset producing dense numpy samples."""

    def __init__(self, proposals_file: str, gt_candidates_file: str,
                 pose_file: str, occ_anno_root: str | None,
                 cfg: OcOccNetConfig,
                 class_names: Sequence[str] = ("Car",),
                 min_tracklet_points: int = 100,
                 min_tracklet_length: int | None = None,
                 training: bool = True, load_interval: int = 1,
                 mirror_occ: bool = False, frame_dropout: float = 0.0,
                 occ_info_file: str | None = None,
                 occ_compute_score: bool = False):
        # ctor args kept so loader worker processes (spawn start method)
        # can rebuild an identical dataset without pickling this object
        self._ctor_kwargs = dict(
            proposals_file=proposals_file,
            gt_candidates_file=gt_candidates_file, pose_file=pose_file,
            occ_anno_root=occ_anno_root, cfg=cfg,
            class_names=tuple(class_names),
            min_tracklet_points=min_tracklet_points,
            min_tracklet_length=min_tracklet_length, training=training,
            load_interval=load_interval, mirror_occ=mirror_occ,
            frame_dropout=frame_dropout, occ_info_file=occ_info_file,
            occ_compute_score=occ_compute_score)
        self.cfg = cfg
        self.training = training
        # augmentation can be toggled off mid-training
        # (DisableAugmentationHook, core/hook/fsd_hooks.py:7-54)
        self.augment = training
        self.mirror_occ = mirror_occ
        # FrameDropout pipeline (tracklet_pipelines.py:626-651): randomly
        # drop a fraction of frames before regularization (train only)
        self.frame_dropout = frame_dropout
        self.occ_anno_root = occ_anno_root
        self.class_names = list(class_names)
        # Waymo object types of the selected classes (reference ships
        # vehicle (1), pedestrian (2, configs/ctrl/ctrl_ped_24e.py) and
        # cyclist (4, ctrl_cyc_12e.py) variants)
        type_of = {"Car": 1, "Vehicle": 1, "Pedestrian": 2, "Ped": 2,
                   "Cyclist": 4, "Cyc": 4}
        self.types = {type_of[c] for c in self.class_names}
        # optional predicted-track occ annotation info: trk_id ->
        # (anno_uuid, label_iou, label_trk_length) — the `oid2occ` path of
        # `WaymoTrackletDatasetWithOcc.parse_occ_anno`
        # (waymo_tracklet_dataset.py:562-586); absent = GT annos (iou 1.0)
        self.oid2occ = (_load_pkl(occ_info_file) if occ_info_file else None)
        # LoadAnnotationsOcc(compute_score=True): score = known fraction
        self.occ_compute_score = occ_compute_score
        min_len = (min_tracklet_length if min_tracklet_length is not None
                   else (cfg.reg_len if training else 1))

        infos = _load_pkl(proposals_file)
        cands = _load_pkl(gt_candidates_file)
        assert len(infos) == len(cands), (len(infos), len(cands))
        pts_dir = proposals_file.replace(".pkl", "_database")

        self.records, self.candidates, self.pts_files = [], [], []
        for info, cand in zip(infos, cands):
            rec = TrackletRecord.from_dump(info)
            # filters mirror WaymoTrackletDataset(+WithOcc).__init__
            if rec.num_pts is not None and rec.num_pts.sum() < \
                    min_tracklet_points:
                continue
            if rec.type not in self.types:   # class filter (`e[2] == type`)
                continue
            if len(rec) < min_len:
                continue
            self.records.append(rec)
            self.candidates.append(
                [TrackletRecord.from_dump(c) for c in cand])
            self.pts_files.append(os.path.join(
                pts_dir, f"{rec.segment_name}--{rec.id}.npy"))
        self.records = self.records[::load_interval]
        self.candidates = self.candidates[::load_interval]
        self.pts_files = self.pts_files[::load_interval]
        # select_candidate is deterministic in (record, candidates) —
        # memoized per index (it was 69% of build_sample when recomputed
        # every epoch: per-frame rotated-IoU over every candidate)
        self._cand_cache: dict = {}
        # parsed-occ LRU (see _load_occ_grid); ~10 KB/entry worst case
        self._occ_cache: "OrderedDict" = OrderedDict()
        self._occ_cache_max = 8192

        self.poses = {k: np.asarray(v, np.float64)
                      for k, v in _load_pkl(pose_file).items()}

    def __len__(self):
        return len(self.records)

    # ------------------------------------------------------------------
    def select_candidate(self, rec: TrackletRecord,
                         cands: list[TrackletRecord],
                         thresh: float = 0.5) -> int:
        """argmax over candidates of #frames with aligned IoU > thresh
        (``tracklet_roi_head_occ.py:993-1027``). Returns -1 if empty."""
        if not cands:
            return -1
        best, best_n = -1, -1
        ts_idx = {t: i for i, t in enumerate(rec.ts)}
        for ci, cand in enumerate(cands):
            common = [(ts_idx[t], j) for j, t in enumerate(cand.ts)
                      if t in ts_idx]
            n = 0
            if common:
                ii = np.asarray([c[0] for c in common])
                jj = np.asarray([c[1] for c in common])
                ious = npg.aligned_iou_3d(rec.boxes[ii], cand.boxes[jj])
                n = int((ious > thresh).sum())
            if n > best_n:
                best, best_n = ci, n
        return best

    def sample_occ(self, segment: str, trk_id: str, rng: np.random.RandomState
                   ) -> tuple[np.ndarray, np.ndarray, float]:
        """Load the occ grid and draw balanced occupied/free voxel-center
        samples in the grid's gravity-centered frame
        (``RandomSampleOccPoints``, balance_sample path).

        The returned score is the annotation confidence ``label_iou``
        (``parse_occ_anno``, ``waymo_tracklet_dataset.py:562-586``): 1.0 for
        GT annotations, the candidates-pkl mIoU for predicted-track
        annotations (``oid2occ``), the known-voxel fraction when
        ``occ_compute_score`` (``LoadAnnotationsOcc``,
        ``occ_pinelines.py:44-58``), and 0.0 for missing/degenerate grids —
        the trainer gates occ loss at ``occ_label_thresh``."""
        K = self.cfg.num_occ_samples
        base_score = 1.0
        if self.oid2occ is not None:
            info = self.oid2occ.get(trk_id)
            if info is None:
                path = None
            else:
                anno_uuid, miou, _trk_len = info
                seg_a, tid, _ = anno_uuid.split("__")
                base_score = float(miou)
                path = (os.path.join(self.occ_anno_root, seg_a,
                                     f"{tid}.npz")
                        if self.occ_anno_root else None)
        else:
            path = (os.path.join(self.occ_anno_root, segment,
                                 f"{trk_id}.npz")
                    if self.occ_anno_root else None)
        empty = (np.zeros((K, 3), np.float32), np.zeros((K,), np.int32), 0.0)
        if path is None:
            return empty
        parsed = self._load_occ_grid(path)
        if parsed is None:
            return empty
        shape, known_frac, pos_idx, neg_idx, vals = parsed
        if self.occ_compute_score:
            base_score = known_frac
        vs = self.cfg.ae_voxel_size
        size = np.asarray(shape) * vs
        if len(pos_idx) == 0 or len(neg_idx) == 0:
            # degenerate grid: "do not use this sample"
            # (occ_pinelines.py:265-273)
            idx = np.concatenate([pos_idx, neg_idx])
            j = rng.choice(len(idx), K, replace=len(idx) < K)
            sel = idx[j]
            labels = (vals[j] == 1).astype(np.int32)
            score = 0.0
        else:
            npos = K // 2
            sel = np.concatenate([
                rng.choice(pos_idx, npos, replace=len(pos_idx) < npos),
                rng.choice(neg_idx, K - npos,
                           replace=len(neg_idx) < (K - npos))])
            labels = np.zeros((K,), np.int32)
            labels[:npos] = 1
            score = base_score
        coors = np.stack(np.unravel_index(sel, shape), -1)
        centers = (coors + 0.5) * vs - size / 2
        return centers.astype(np.float32), labels, score

    def _load_occ_grid(self, path: str):
        """Parse (and LRU-memoize) an occ npz into the compact arrays
        sampling needs: ``(shape, known_frac, pos_idx, neg_idx, vals)``
        where ``vals`` are the known-voxel labels aligned with
        ``concat(pos_idx, neg_idx)``. The grid itself is never kept — per
        track this is a few KB, so a warm cache removes the npz
        open/decompress/nonzero from every epoch after the first."""
        # lazy init so hand-constructed datasets (tests, surgery tools)
        # that bypass __init__ still work
        cache = getattr(self, "_occ_cache", None)
        if cache is None:
            cache = self._occ_cache = OrderedDict()
            self._occ_cache_max = 8192
        cached = cache.get(path, _CACHE_MISS)
        if cached is not _CACHE_MISS:
            cache.move_to_end(path)
            return cached

        def put(value):
            cache[path] = value
            if len(cache) > self._occ_cache_max:
                cache.popitem(last=False)
            return value

        if not os.path.exists(path):
            return put(None)
        try:
            occ = np.load(path)["occ"]
        except Exception:
            # transient failure (partial write, I/O error): do NOT
            # negatively cache — the next epoch retries the load
            return None
        # known fraction scores the PRE-mirror annotation
        # (LoadAnnotationsOcc computes it at load time, before MirrorOccLabel)
        known_frac = float((occ != 0).sum()) / max(occ.size, 1)
        if self.mirror_occ:
            occ = mirror_occ_label(occ)
        flat = occ.reshape(-1)
        # int32: grid flat size is far below 2^31, halves cache bytes
        idx = np.nonzero(flat != 0)[0].astype(np.int32)
        if idx.size == 0:
            return put(None)
        vals = flat[idx].astype(np.int8)
        pos_idx = idx[vals == 1]
        neg_idx = idx[vals != 1]
        vals_sorted = np.concatenate([np.ones(len(pos_idx), np.int8),
                                      vals[vals != 1]])
        return put((occ.shape, known_frac, pos_idx, neg_idx, vals_sorted))

    # ------------------------------------------------------------------
    def build_sample(self, index: int, rng: np.random.RandomState) -> dict:
        cfg = self.cfg
        rec = self.records[index]
        cands = self.candidates[index]
        L, P, K = cfg.reg_len, cfg.max_points_per_frame, cfg.num_occ_samples

        points_list = np.load(self.pts_files[index], allow_pickle=True)
        assert len(points_list) == len(rec), "points/boxes length mismatch"
        T = len(rec)

        # --- occupancy GT (sampled in GT-grid frame, before any aug) ---
        ci = self._cand_cache.get(index)
        if ci is None:
            ci = self.select_candidate(rec, cands)
            self._cand_cache[index] = ci
        if ci >= 0:
            gt_rec = cands[ci]
            occ_pts, occ_lab, occ_score = self.sample_occ(
                gt_rec.segment_name, gt_rec.id, rng)
        else:
            gt_rec = None
            occ_pts = np.zeros((K, 3), np.float32)
            occ_lab = np.zeros((K,), np.int32)
            occ_score = 0.0

        # --- frame dropout (FrameDropout) ---
        if self.training and self.augment and self.frame_dropout > 0 \
                and T > 2:
            keep = rng.rand(T) >= self.frame_dropout
            keep[0] = True   # always keep at least the first frame
            if keep.sum() >= 2:
                idx = np.nonzero(keep)[0]
                rec = dataclasses.replace(
                    rec, boxes=rec.boxes[idx],
                    ts=[rec.ts[i] for i in idx],
                    scores=rec.scores[idx],
                    num_pts=None if rec.num_pts is None
                    else rec.num_pts[idx])
                points_list = [points_list[i] for i in idx]
                T = len(rec)

        # --- regularize to L frames (TrackletRegularization) ---
        # Train: random L-frame crop (pad short tracklets by repeating the
        # last frame, like the reference). Test: keep the full tracklet; the
        # eval harness pads to a static length bucket afterwards.
        if self.training:
            if T > L:
                head = rng.randint(0, T - L + 1)
                frames = list(range(head, head + L))
            else:
                frames = list(range(T)) + [T - 1] * (L - T)
        else:
            frames = list(range(T))

        boxes = rec.boxes[frames]
        scores = rec.scores[frames]
        ts = [rec.ts[f] for f in frames]
        poses = np.stack([self.poses[t] for t in ts], 0)
        Lf = len(frames)

        # --- pose transform into the middle frame (TrackletPoseTransform) ---
        center_pose = poses[Lf // 2]
        inv = np.linalg.inv(center_pose)
        boxes = pose_transform_boxes(boxes, poses, inv)
        # per-frame ego->middle matrices, fused with the cap/pad-to-P copy
        # so each frame's points move once, straight into the padded buffer
        mm = inv[None] @ poses                                # [Lf, 4, 4]
        points = np.zeros((Lf, P, 3 + cfg.num_point_feats), np.float32)
        mask = np.zeros((Lf, P), bool)
        for i, f in enumerate(frames):
            p = np.asarray(points_list[f], np.float32)
            if len(p) > P:
                p = p[rng.permutation(len(p))[:P]]
            n = len(p)
            points[i, :n, :3] = pose_transform_points(p[:, :3], mm[i])
            points[i, :n, 3:5] = p[:, 3:5]
            mask[i, :n] = True

        gt_boxes = np.zeros((Lf, 7), np.float32)
        gt_valid = np.zeros((Lf,), bool)
        if gt_rec is not None and len(gt_rec):
            gt_idx = {t: i for i, t in enumerate(gt_rec.ts)}
            gt_poses = np.stack([self.poses[t] for t in gt_rec.ts], 0)
            gt_all = pose_transform_boxes(gt_rec.boxes, gt_poses, inv)
            for i, t in enumerate(ts):
                if t in gt_idx:
                    gt_boxes[i] = gt_all[gt_idx[t]]
                    gt_valid[i] = True

        # --- proposal noise (TrackletNoise, per-frame iid uniform;
        # centers additive, sizes MULTIPLICATIVE `* (1 + u)` — the
        # reference's add_size_noise, lidar_tracklet.py:519-537) ---
        if self.training and self.augment:
            boxes = boxes.copy()
            boxes[:, 0:3] += rng.uniform(-1, 1, (Lf, 3)) * [0.2, 0.2, 0.1]
            boxes[:, 3:6] *= 1 + rng.uniform(-1, 1, (Lf, 3)) * [0.2, 0.2, 0.1]
            boxes[:, 6] += rng.uniform(-0.2, 0.2, Lf)

        # --- decoration (PointDecoration: yaw, size, score; the yaw
        # normalizer is the reference's literal 3.1415, not pi —
        # tracklet_pipelines.py:585) ---
        points[:, :, 5] = boxes[:, 6:7] / 3.1415
        points[:, :, 6:9] = boxes[:, None, 3:6] / 10.0
        points[:, :, 9] = scores[:, None]
        points[:, :, 5:] *= mask[:, :, None]      # padded slots stay zero

        # --- global flips / rot / scale / trans (train only) ---
        if self.training and self.augment:
            if rng.rand() < 0.5:
                apply_flip(points, (boxes, gt_boxes), horizontal=True)
            if rng.rand() < 0.5:
                apply_flip(points, (boxes, gt_boxes), horizontal=False)
            ang = rng.uniform(-np.pi / 4, np.pi / 4)
            sc = rng.uniform(0.95, 1.05)
            tr = np.array([0, 0, rng.normal(0, 0.2)], np.float32)
            apply_rot_scale_trans(points, (boxes, gt_boxes), ang, sc, tr)

        # --- range filter (per-axis compares; no [L, P, 3] temporaries) ---
        lo, hi = POINT_RANGE[:3], POINT_RANGE[3:]
        x, y, z = points[..., 0], points[..., 1], points[..., 2]
        mask &= ((x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1])
                 & (z >= lo[2]) & (z <= hi[2]))

        # --- frame indices (random_shift_frame_inds) ---
        if self.training:
            shift = rng.randint(0, cfg.max_frame_ind - Lf + 1)
        else:
            shift = 0
        frame_inds = np.arange(Lf, dtype=np.int32) + shift

        return dict(
            points=points, points_mask=mask,
            rois=boxes.astype(np.float32),
            roi_scores=scores.astype(np.float32),
            frame_inds=frame_inds,
            gt_boxes=gt_boxes, gt_valid=gt_valid,
            occ_points=occ_pts, occ_labels=occ_lab,
            occ_mask=np.ones((K,), bool),
            occ_score=np.float32(occ_score),
            meta=dict(segment=rec.segment_name, id=rec.id, ts=ts),
        )
