"""Detector evaluation (counterpart of the JAX package's
``evalx/detector_eval.py``; the SST, CenterPoint, FSD, two-stage FSD,
FSD++ and VoteNet families):
prediction over the val frames on the model's device, score filtering and
per-class rotated NMS, then KITTI-protocol AP or the Waymo ``.bin`` files
and the native mAP / mAPH. FSD++ walks each segment's frames in time order
with its memory carried from frame to frame (fresh at each segment).

The IoU matrices of the NMS and of the AP are computed on the model's
device; the greedy sweeps, the matching and the files stay on the host.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..data import np_geometry as npg
from ..data.frame_dataset import CLASS_MAP
from ..models.fsdpp import init_sequence_state
from .kitti_eval import _pairwise_iou3d, difficulty_from_annos, kitti_eval
from .waymo_bin import _CLASS_TO_WAYMO, WaymoObject, write_bin
from .waymo_metrics import compute_metrics


def host_nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.25,
             max_out: int = 200, device="cpu") -> np.ndarray:
    """Greedy rotated 3D NMS; returns the kept indices in descending score
    order. The pairwise IoU matrix is computed once on ``device``; the
    suppression sweep runs on the host."""
    n = len(boxes)
    if n == 0:
        return np.asarray([], np.int64)
    order = np.argsort(-scores)
    iou = _pairwise_iou3d(boxes[order], boxes[order], device)
    alive = np.ones(n, bool)
    keep = []
    for i in range(n):
        if not alive[i]:
            continue
        keep.append(int(order[i]))
        if len(keep) >= max_out:
            break
        alive &= ~(iou[i] > iou_thresh)
        alive[i] = False
    return np.asarray(keep, np.int64)


def make_predict_fn(model, family: str):
    """``(points, mask) -> (boxes [K, 7] (CenterPoint: [K, 9], velocity
    last), scores [K], labels [K], valid [K])``, fixed output size, on the
    model's device. The model holds its own weights (the JAX version takes
    them as an argument). ``fsd``: one box per cluster slot, scored by its
    best task and decoded with that task's regression; ``fsd2``: the
    refined boxes, scored by stage 2, labelled by stage 1's best task;
    ``votenet``: the proposals' boxes, sigmoid(objectness) x proposal
    mask, the best class and the proposal mask."""
    if family in ("sst", "centerpoint", "votenet"):
        def fn(points, mask):
            return model.predict(points, mask)
    elif family == "fsd":
        def fn(points, mask):
            out = model(points, mask)
            labels = out["cls"].argmax(-1)
            boxes = out["boxes_tasks"][
                torch.arange(labels.shape[0], device=labels.device), labels]
            return (boxes, torch.sigmoid(out["cls"].amax(-1)), labels,
                    out["cluster_valid"])
    elif family == "fsd2":
        def fn(points, mask):
            out = model(points, mask)
            return (out["refined_boxes"], torch.sigmoid(out["cls2"]),
                    out["cls"].argmax(-1), out["roi_nonempty"])
    else:
        raise ValueError(f"unknown detector family: {family!r}")
    return torch.inference_mode()(fn)


def make_sequential_predict_fn(model):
    """FSD++: ``(state, points, mask) -> (new state, (boxes [C, 7], scores
    [C], labels [C], valid [C]))``, one sequence step on the model's
    device; the caller threads the state through a sequence. As the JAX
    function, it scores stage 1's own-class boxes with the best task's
    ``sigmoid(max(cls))`` even when the wrapped detector is two-stage."""
    def step(state, points, mask):
        new_state, out = model(state, points, mask)
        return new_state, (out["boxes"], torch.sigmoid(out["cls"].amax(-1)),
                           out["cls"].argmax(-1), out["cluster_valid"])
    return torch.inference_mode()(step)


def _sequential_results(model, dataset, score_thresh, nms_iou, max_frames,
                        seed):
    """Yields (pred, gt, meta) per frame over ``dataset.sequences()``, the
    FSD++ memory carried across a segment's frames and fresh at each
    segment's start. The NMS is over every class at once, as in the JAX
    function."""
    device = _model_device(model)
    step = make_sequential_predict_fn(model)
    rng = np.random.RandomState(seed)
    budget = len(dataset) if max_frames is None else max_frames
    done = 0
    for seq in dataset.sequences():
        mem = None
        for idx in seq:
            if done >= budget:
                return
            s = dataset.build_sample(idx, rng)
            if mem is None:
                mem = init_sequence_state(model.cfg, s["points"].shape[-1],
                                          device)
            mem, out = step(mem, torch.from_numpy(s["points"]).to(device),
                            torch.from_numpy(s["points_mask"]).to(device))
            b, sc, lb, ok = (np.asarray(x.cpu()) for x in out)
            keep = ok & (sc > score_thresh) & np.isfinite(b).all(-1)
            b, sc, lb = b[keep], sc[keep], lb[keep]
            if len(b):
                k = host_nms(b, sc, nms_iou, device=device)
                b, sc, lb = b[k], sc[k], lb[k]
            gt, meta = _gt_and_meta(dataset, idx, s)
            yield dict(boxes=b, scores=sc, labels=lb), gt, meta
            done += 1


def evaluate_detector_sequential(model, dataset, classes=("Car",),
                                 score_thresh: float = 0.1,
                                 nms_iou: float = 0.25,
                                 max_frames: int | None = None,
                                 seed: int = 0, metric: str = "kitti",
                                 out_dir: str | None = None) -> dict:
    """FSD++ evaluation over memory-threaded sequences: KITTI AP
    (``metric="kitti"``) or the native Waymo mAP / mAPH (``"waymo"``,
    which needs ``out_dir`` for the ``.bin`` files)."""
    results = _sequential_results(model, dataset, score_thresh, nms_iou,
                                  max_frames, seed)
    if metric == "waymo":
        assert out_dir is not None, "waymo metric needs out_dir"
        return _score_waymo(results, out_dir, classes)
    preds, gts = [], []
    for pred, gt, _ in results:
        preds.append(pred)
        gts.append(gt)
    return kitti_eval(preds, gts, classes=classes,
                      device=_model_device(model))


def points_in_box_host(points_xyz: np.ndarray, box: np.ndarray,
                       margin: float = 0.0) -> np.ndarray:
    """Boolean mask of the points inside one [x, y, z_bottom, w, l, h, yaw]
    box (a copy of the JAX package's ``data/dbsampler.py`` function)."""
    local = npg.rotate_z(points_xyz - box[None, :3]
                         - np.array([0.0, 0.0, box[5] / 2.0]), -box[6])
    half = box[3:6] / 2.0 + margin
    return np.all(np.abs(local) <= half[None], axis=-1)


def _model_device(model) -> torch.device:
    if model is None:
        return torch.device("cpu")
    return next(model.parameters()).device


def evaluate_detector(model, family: str, dataset, classes=("Car",),
                      score_thresh: float = 0.1, nms_iou: float = 0.25,
                      max_frames: int | None = None, seed: int = 0,
                      predict_fn=None, iou_thresh: dict | None = None
                      ) -> dict:
    """Run the detector over the frames of ``dataset`` (a ``FrameDataset``)
    and return KITTI AP_R40 per class and difficulty; the GT difficulty
    comes from the kitti-format annos' image-plane box heights.
    ``predict_fn`` (``make_predict_fn``'s signature) replaces the model's
    prediction, for oracle checks of the metric; without a model it gets
    CPU tensors."""
    device = _model_device(model)
    preds, gts = [], []
    for pred, gt, _ in _frame_results(model, family, dataset, score_thresh,
                                      nms_iou, max_frames, seed, predict_fn,
                                      device):
        preds.append(pred)
        gts.append(gt)
    return kitti_eval(preds, gts, classes=classes, iou_thresh=iou_thresh,
                      device=device)


def _frame_results(model, family, dataset, score_thresh, nms_iou,
                   max_frames, seed, predict_fn, device):
    """Yields (pred dict, gt dict, meta dict) per frame: the loop shared by
    the KITTI and the Waymo evaluation."""
    predict = predict_fn or make_predict_fn(model, family)
    rng = np.random.RandomState(seed)
    n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
    for i in range(n):
        s = dataset.build_sample(i, rng)
        out = predict(torch.from_numpy(s["points"]).to(device),
                      torch.from_numpy(s["points_mask"]).to(device))
        b, sc, lb, ok = (np.asarray(x.cpu()) if isinstance(x, torch.Tensor)
                         else np.asarray(x) for x in out)
        b = b[:, :7]
        m = ok & (sc > score_thresh) & np.isfinite(b).all(-1)
        b, sc, lb = b[m], sc[m], lb[m]
        if len(b):
            # per-class NMS: boxes of different classes never suppress
            # each other
            keep = np.zeros(len(b), bool)
            for cls_id in np.unique(lb):
                cm = np.nonzero(lb == cls_id)[0]
                k = host_nms(b[cm], sc[cm], nms_iou, device=device)
                keep[cm[k]] = True
            b, sc, lb = b[keep], sc[keep], lb[keep]
        pred = dict(boxes=b, scores=sc, labels=lb)
        gt, meta = _gt_and_meta(dataset, i, s)
        yield pred, gt, meta


def _gt_and_meta(dataset, idx, s):
    """Per-frame GT (with the annos' difficulty realigned to the kept
    boxes) and frame metadata."""
    gv = s["gt_valid"]
    # the Argoverse 2 reader lists files, not infos; nuScenes infos carry
    # no ``point_cloud`` (the JAX function raises on both)
    info = dataset.infos[idx] if hasattr(dataset, "infos") else {}
    annos = info.get("annos", {})
    if "name" in annos:
        diff = difficulty_from_annos(annos)
        # annos rows of DontCare / unknown classes were dropped by the box
        # conversion; realign the difficulty to the kept rows
        names = np.asarray(annos["name"])
        kept = np.asarray([CLASS_MAP.get(nm, -1) >= 0 for nm in names])
        diff = diff[kept][:int(gv.sum())]
    else:
        diff = np.zeros(int(gv.sum()), np.int32)
    gt = dict(boxes=s["gt_boxes"][gv], labels=s["gt_labels"][gv],
              difficulty=diff)
    meta = dict(
        segment=info.get("segment_name",
                         info.get("point_cloud", {}).get("segment_name",
                                                         f"seg-{idx}")),
        timestamp=int(info.get("timestamp", idx)),
        points=np.asarray(s["points"])[np.asarray(s["points_mask"])],
        index=idx)
    return gt, meta


def evaluate_detector_waymo(model, family: str, dataset, out_dir: str,
                            classes=("Car",), score_thresh: float = 0.05,
                            nms_iou: float = 0.25,
                            max_frames: int | None = None, seed: int = 0,
                            predict_fn=None) -> dict:
    """Waymo-protocol detector evaluation: predictions and GT go into
    wire-format ``.bin`` files and the native binary computes mAP / mAPH.
    GT difficulty: LEVEL_2 where the box holds fewer than 5 points of the
    frame's own cloud."""
    results = _frame_results(model, family, dataset, score_thresh, nms_iou,
                             max_frames, seed, predict_fn,
                             _model_device(model))
    return _score_waymo(results, out_dir, classes)


def _score_waymo(results, out_dir: str, classes) -> dict:
    """(pred, gt, meta) stream -> pred / gt .bin files -> native binary."""
    pred_objs, gt_objs = [], []
    for pred, gt, meta in results:
        seg, ts = meta["segment"], meta["timestamp"]
        for j, (box, sc, lb) in enumerate(zip(pred["boxes"],
                                              pred["scores"],
                                              pred["labels"])):
            wtype = _CLASS_TO_WAYMO[classes[int(lb)]]
            pred_objs.append(WaymoObject(
                tuple(box[:7]), float(sc), wtype, f"p{meta['index']}_{j}",
                seg, ts))
        xyz = meta["points"][:, :3]
        for j, (box, lb) in enumerate(zip(gt["boxes"], gt["labels"])):
            npts = int(points_in_box_host(xyz, np.asarray(box)).sum())
            gt_objs.append(WaymoObject(
                tuple(box[:7]), 1.0, _CLASS_TO_WAYMO[classes[int(lb)]],
                f"g{meta['index']}_{j}", seg, ts,
                num_lidar_points=npts, difficulty=1))
    os.makedirs(out_dir, exist_ok=True)
    pred_bin = os.path.join(out_dir, "pred.bin")
    gt_bin = os.path.join(out_dir, "gt.bin")
    write_bin(pred_objs, pred_bin)
    write_bin(gt_objs, gt_bin)
    return compute_metrics(pred_bin, gt_bin)
