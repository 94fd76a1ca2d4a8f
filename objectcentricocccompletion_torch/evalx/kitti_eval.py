"""KITTI-protocol 3D detection AP (counterpart of the JAX package's
``evalx/kitti_eval.py``): per class and difficulty, R40-interpolated
average precision with rotated 3D IoU matching, harder-difficulty GT
ignored, and the easy / moderate / hard gating by box height, occlusion
and truncation.

Boxes use the LiDAR layout [x, y, z_bottom, w, l, h, yaw]. The IoU
matrices come from ``core/boxes.py::pairwise_iou_3d`` in float32 on
``device`` (the CPU unless the caller passes another); the JAX package
pads them to size buckets for its compiler, which torch does not need.
The matching and the AP stay numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import boxes as box_ops

DIFFICULTY_PARAMS = {   # min_height(px), max_occlusion, max_truncation
    0: (40, 0, 0.15),   # easy
    1: (25, 1, 0.30),   # moderate
    2: (25, 2, 0.50),   # hard
}
IOU_THRESH = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}


def _pairwise_iou3d(a: np.ndarray, b: np.ndarray, device="cpu"
                    ) -> np.ndarray:
    """Pairwise rotated 3D IoU ``[len(a), len(b)]`` of float32 boxes."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ta = torch.as_tensor(np.asarray(a, np.float32), device=device)
    tb = torch.as_tensor(np.asarray(b, np.float32), device=device)
    return box_ops.pairwise_iou_3d(ta, tb).cpu().numpy()


def batch_pairwise_iou(pred_boxes_list, gt_boxes_list, device="cpu"):
    """The per-frame pairwise IoU matrices of many frames."""
    return [_pairwise_iou3d(p, g, device)
            for p, g in zip(pred_boxes_list, gt_boxes_list)]


def gt_difficulty(heights_px, occlusions, truncations) -> np.ndarray:
    """KITTI difficulty index per GT (3 = ignored at every level)."""
    out = np.full(len(heights_px), 3, np.int32)
    for d in (2, 1, 0):
        hmin, omax, tmax = DIFFICULTY_PARAMS[d]
        ok = (heights_px >= hmin) & (occlusions <= omax) \
            & (truncations <= tmax)
        out[ok] = d
    return out


def difficulty_from_annos(annos: dict) -> np.ndarray:
    """Per-GT difficulty from kitti-format ``annos``: the image-plane box
    height in pixels from ``bbox`` [x1, y1, x2, y2] and the ``occluded`` /
    ``truncated`` flags. Missing fields count as unoccluded / untruncated;
    a missing ``bbox`` counts as tall enough for easy."""
    if "name" in annos:
        n = len(annos["name"])
    elif "bbox" in annos:
        n = len(annos["bbox"])
    else:
        # indoor annos carry no image-plane fields: every GT counts as easy
        n = len(annos.get("class",
                          annos.get("gt_boxes_upright_depth", [])))
    if "bbox" in annos and len(annos["bbox"]):
        bbox = np.asarray(annos["bbox"], np.float64)
        heights = bbox[:, 3] - bbox[:, 1]
    else:
        heights = np.full(n, 1e4)
    occ = np.asarray(annos.get("occluded", np.zeros(n)), np.int64)
    trunc = np.asarray(annos.get("truncated", np.zeros(n)), np.float64)
    return gt_difficulty(heights, occ, trunc)


def eval_class(pred_boxes_list, pred_scores_list, gt_boxes_list,
               gt_difficulty_list, difficulty: int,
               iou_thresh: float, iou_list=None) -> float:
    """AP_R40 over a list of frames.

    GT with difficulty <= d are counted; harder GT are ignored: matching
    predictions are neither TP nor FP (KITTI dontcare semantics).
    ``iou_list`` supplies precomputed per-frame IoU matrices."""
    if iou_list is None:
        iou_list = batch_pairwise_iou(pred_boxes_list, gt_boxes_list)
    scores, kinds = [], []
    num_gt = 0
    for pb, ps, gb, gd, iou in zip(pred_boxes_list, pred_scores_list,
                                   gt_boxes_list, gt_difficulty_list,
                                   iou_list):
        counted = gd <= difficulty
        num_gt += int(counted.sum())
        if len(pb) == 0:
            continue
        order = np.argsort(-ps)
        used = np.zeros(len(gb), bool)
        for pi in order:
            if len(gb):
                row = np.where(used, -1.0, iou[pi])
                best = int(row.argmax())
                hit = row[best] >= iou_thresh
            else:
                hit = False
            if hit:
                used[best] = True
                kinds.append(1 if counted[best] else 2)  # TP or ignored
            else:
                kinds.append(0)                          # FP
            scores.append(ps[pi])
    if num_gt == 0:
        return 0.0
    scores = np.asarray(scores)
    kinds = np.asarray(kinds)
    order = np.argsort(-scores)
    kinds = kinds[order]
    keep = kinds != 2
    tp = np.cumsum(kinds[keep] == 1)
    fp = np.cumsum(kinds[keep] == 0)
    recall = tp / num_gt
    precision = tp / np.maximum(tp + fp, 1)
    # monotone envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    # R40: precision sampled at the 40 recall positions 1/40 .. 40/40
    ap = 0.0
    for r in np.linspace(1 / 40, 1.0, 40):
        idx = np.searchsorted(recall, r)
        ap += (precision[idx] if idx < len(precision) else 0.0) / 40
    return float(ap)


def kitti_eval(predictions: list, ground_truths: list,
               classes=("Car",), iou_thresh: dict | None = None,
               device="cpu") -> dict:
    """predictions: per frame dict(boxes [N, 7], scores [N], labels [N]);
    ground_truths: per frame dict(boxes [M, 7], labels [M], difficulty
    [M]). Returns {"<cls>_3d_<easy|moderate|hard>": AP_R40}.
    ``iou_thresh`` overrides the per-class match thresholds."""
    out = {}
    thresh = {**IOU_THRESH, **(iou_thresh or {})}
    names = ["easy", "moderate", "hard"]
    for ci, cls in enumerate(classes):
        pb = [p["boxes"][p["labels"] == ci] for p in predictions]
        ps = [p["scores"][p["labels"] == ci] for p in predictions]
        gb = [g["boxes"][g["labels"] == ci] for g in ground_truths]
        gd = [g["difficulty"][g["labels"] == ci] for g in ground_truths]
        ious = batch_pairwise_iou(pb, gb, device)  # shared by difficulties
        for d in (0, 1, 2):
            out[f"{cls}_3d_{names[d]}"] = eval_class(
                pb, ps, gb, gd, d, thresh.get(cls, 0.5), iou_list=ious)
    return out
