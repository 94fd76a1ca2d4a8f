"""Test-time augmentation for tracklet refinement (counterpart of the JAX
package's ``evalx/tta.py``): run the model on the identity and the flipped
variants of a batch, move each prediction back to the original frame and
merge them, by default with the reference's ``'weighted'`` semantics
(score-weighted geometry mean, median yaw), or with a heading-vector mean
(``merge='vector'``).

The flips build new tensors: neither the caller's batch nor the identity
variant's output is edited in place.
"""
from __future__ import annotations

import math

import torch

from ..data.tracklet import TrackletBatch

FLIPS = ((False, False), (True, False), (False, True), (True, True))


def _flip_boxes(boxes: torch.Tensor, fh: bool, fv: bool) -> torch.Tensor:
    boxes = boxes.clone()
    if fh:
        boxes[..., 1] *= -1
        boxes[..., 6] = -boxes[..., 6] + math.pi
    if fv:
        boxes[..., 0] *= -1
        boxes[..., 6] *= -1
    return boxes


def flip_batch(batch: TrackletBatch, fh: bool, fv: bool) -> TrackletBatch:
    """BEV flips of the points and boxes (horizontal: y -> -y, yaw -> pi -
    yaw; vertical: x -> -x, yaw -> -yaw), on copies."""
    if not (fh or fv):
        return batch
    pts = batch.points.clone()
    if fh:
        pts[..., 1] *= -1
    if fv:
        pts[..., 0] *= -1
    return batch._replace(points=pts,
                          rois=_flip_boxes(batch.rois, fh, fv),
                          gt_boxes=_flip_boxes(batch.gt_boxes, fh, fv))


def unflip_boxes(boxes: torch.Tensor, fh: bool, fv: bool) -> torch.Tensor:
    """Inverse of the box flip (each flip is an involution), on a copy."""
    boxes = boxes.clone()
    if fv:
        boxes[..., 0] *= -1
        boxes[..., 6] *= -1
    if fh:
        boxes[..., 6] = -(boxes[..., 6] - math.pi)
        boxes[..., 1] *= -1
    return boxes


def median(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values for an even count
    (``torch.median`` returns the lower one)."""
    s = torch.sort(x, dim).values
    n = s.shape[dim]
    hi = s.narrow(dim, n // 2, 1).squeeze(dim)
    if n % 2:
        return hi
    lo = s.narrow(dim, n // 2 - 1, 1).squeeze(dim)
    return 0.5 * lo + 0.5 * hi


def merge_boxes_weighted(box_list: list, score_list: list) -> tuple:
    """The reference's ``merge='weighted'``: score-weighted mean of the 6
    geometry dims, the median yaw across the variants and the plain mean
    of the scores."""
    all_boxes = torch.stack(box_list)          # [A, ..., 7]
    all_scores = torch.stack(score_list)       # [A, ...]
    geom = ((all_boxes[..., :6] * all_scores[..., None]).sum(0)
            / all_scores.sum(0)[..., None])
    yaw = median(all_boxes[..., 6], 0)
    return torch.cat([geom, yaw[..., None]], -1), all_scores.mean(0)


def merge_boxes(box_list: list, score_list: list) -> tuple:
    """``merge='vector'``: unweighted mean of centres and sizes; the yaw
    from the mean heading vector, each candidate turned to face the first
    one's way; the mean score."""
    ref = box_list[0]
    sins, coss = [], []
    for b in box_list:
        flip = torch.cos(b[..., 6] - ref[..., 6]) < 0
        yaw = torch.where(flip, b[..., 6] + math.pi, b[..., 6])
        sins.append(torch.sin(yaw))
        coss.append(torch.cos(yaw))
    yaw = torch.atan2(sum(sins) / len(sins), sum(coss) / len(coss))
    geom = sum(b[..., :6] for b in box_list) / len(box_list)
    return (torch.cat([geom, yaw[..., None]], -1),
            sum(score_list) / len(score_list))


def predict_tta(apply_fn, batch: TrackletBatch, flips=FLIPS,
                merge: str = "weighted") -> dict:
    """``apply_fn(batch)`` -> dict with 'boxes' [B, L, 7], 'scores',
    'nonempty', ...; runs every flip variant and merges. The other entries
    come from the first variant (the identity)."""
    box_list, score_list = [], []
    base = None
    for fh, fv in flips:
        out = apply_fn(flip_batch(batch, fh, fv))
        box_list.append(unflip_boxes(out["boxes"], fh, fv))
        score_list.append(out["scores"])
        if base is None:
            base = out
    merge_fn = merge_boxes_weighted if merge == "weighted" else merge_boxes
    boxes, scores = merge_fn(box_list, score_list)
    return dict(base, boxes=boxes, scores=scores)
