"""FSD++ seed boxes (counterpart of the JAX package's ``ops/seeds.py``):

* ``seeds_from_output``: a frame's detections become the next frame's seeds,
  filtered by score and cut to the best ``capacity``;
* ``seed_fp_insertion``: training adds jittered copies of a random subset,
  shifted up to 10 m in x and y, as false-positive seeds;
* ``seed_dropout_step`` / ``seed_dropout_chain``: training drops seeds at
  random, each seed inheriting the decision of the previous frame's seed it
  overlaps best (BEV IoU > 0.3), so that a dropped object stays dropped;
* ``crop_points_by_seeds``: the points inside any valid (enlarged) seed box,
  at most ``max_crop_points`` per box in scan order;
* ``remove_ground``: the ``|z| <= band`` filter.

A fixed capacity ``S`` with a validity mask holds each frame's seeds. The
random draws are uniform tensors that the caller may pass (``SeedNoise``),
or that :func:`draw_seed_noise` takes from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import boxes as box_ops
from ..models.fsd_two_stage import first_in_box


class Seeds(NamedTuple):
    boxes: torch.Tensor    # [S, 7] float32
    labels: torch.Tensor   # [S] int32
    scores: torch.Tensor   # [S] float32
    valid: torch.Tensor    # [S] bool

    def to(self, device) -> "Seeds":
        return Seeds(*(t.to(device) for t in self))


class SeedNoise(NamedTuple):
    """One frame's uniform draws in [0, 1) for the seed augmentation:
    ``drop`` [S] (the window's first frame only), ``copy`` [S] and
    ``shift`` [S, 2]."""
    drop: torch.Tensor
    copy: torch.Tensor
    shift: torch.Tensor


def draw_seed_noise(capacity: int, generator: torch.Generator | None = None,
                    device="cpu") -> SeedNoise:
    """A frame's draws from ``generator`` (on the CPU), moved to
    ``device``."""
    u = torch.rand(4 * capacity, generator=generator).to(device)
    return SeedNoise(u[:capacity], u[capacity:2 * capacity],
                     u[2 * capacity:].reshape(capacity, 2))


def empty_seeds(capacity: int, device="cpu") -> Seeds:
    return Seeds(torch.zeros((capacity, 7), device=device),
                 torch.zeros((capacity,), dtype=torch.int32, device=device),
                 torch.zeros((capacity,), device=device),
                 torch.zeros((capacity,), dtype=torch.bool, device=device))


def seeds_from_output(boxes: torch.Tensor, labels: torch.Tensor,
                      scores: torch.Tensor, valid: torch.Tensor,
                      capacity: int, score_thr: float = 0.1) -> Seeds:
    """Detections -> next-frame seeds: those over ``score_thr``, the best
    ``capacity`` by score. A stable descending sort ranks them, so equal
    scores keep index order as ``lax.top_k`` does (the slots that fail the
    filter all tie at -1)."""
    ok = valid & (scores > score_thr)
    key = torch.where(ok, scores, -1.0)
    top, idx = torch.sort(key, descending=True, stable=True)
    top, idx = top[:capacity], idx[:capacity]
    return Seeds(boxes[idx], labels[idx].to(torch.int32),
                 scores[idx].float(), top > 0)


def seed_fp_insertion(seeds: Seeds, copy_u: torch.Tensor,
                      shift_u: torch.Tensor, fp_rate: float) -> Seeds:
    """Append a shifted copy of every seed: the copy is valid where the
    seed is and ``copy_u`` [S] < ``fp_rate``, and moves by ``(shift_u
    [S, 2] - 0.5) * 20`` m in x and y. The capacity doubles."""
    copy = seeds.valid & (copy_u < fp_rate)
    shift = (shift_u - 0.5) * 20.0
    fp_boxes = torch.cat([seeds.boxes[:, :2] + shift, seeds.boxes[:, 2:]],
                         -1)
    return Seeds(torch.cat([seeds.boxes, fp_boxes], 0),
                 torch.cat([seeds.labels, seeds.labels], 0),
                 torch.cat([seeds.scores, seeds.scores], 0),
                 torch.cat([seeds.valid, copy], 0))


def _inherit(prev_boxes, prev_valid, prev_keep, boxes, valid, iou_thr):
    iou = box_ops.pairwise_iou_bev(prev_boxes, boxes)
    iou = torch.where(prev_valid[:, None] & valid[None, :], iou, -1.0)
    best, best_i = iou.max(0)
    # torch.max along a dim and jnp.argmax both return the first maximum
    return torch.where(best > iou_thr, prev_keep[best_i], True) & valid


def seed_dropout_step(prev_boxes, prev_valid, prev_keep, boxes: torch.Tensor,
                      valid: torch.Tensor, drop_u: torch.Tensor,
                      drop_rate: float, iou_thr: float = 0.3
                      ) -> torch.Tensor:
    """One frame of the dropout: each seed inherits the keep decision of
    the previous frame's seed it overlaps best (BEV IoU > ``iou_thr``) and
    keeps where none does. ``prev_boxes`` None marks the window's first
    frame, where each valid seed keeps with ``drop_u`` [S] > ``drop_rate``
    (the reference draws only there)."""
    if prev_boxes is None:
        return (drop_u > drop_rate) & valid
    return _inherit(prev_boxes, prev_valid, prev_keep, boxes, valid,
                    iou_thr)


def seed_dropout_chain(boxes: torch.Tensor, valid: torch.Tensor,
                       drop_u: torch.Tensor, drop_rate: float,
                       iou_thr: float = 0.3) -> torch.Tensor:
    """The dropout over a window: boxes [T, S, 7], valid [T, S], the first
    frame's draws ``drop_u`` [S] -> keep [T, S]."""
    keep = [(drop_u > drop_rate) & valid[0]]
    for t in range(1, valid.shape[0]):
        keep.append(_inherit(boxes[t - 1], valid[t - 1], keep[-1], boxes[t],
                             valid[t], iou_thr))
    return torch.stack(keep)


def crop_points_by_seeds(points: torch.Tensor, mask: torch.Tensor,
                         seeds: Seeds, max_crop_points: int = 256,
                         extra_wlh=(1.0, 1.0, 1.0),
                         ground_band: float | None = None) -> torch.Tensor:
    """[N] bool: the points inside a valid seed box enlarged by
    ``extra_wlh``, each counted in its first such box, and at most
    ``max_crop_points`` per box in scan order; with ``ground_band``, the
    ground band ``|z| <= ground_band`` is dropped first. Builds [S, N]
    tensors."""
    if ground_band is not None:
        mask = remove_ground(points, mask, ground_band)
    inside = box_ops.points_in_boxes(points[:, :3], seeds.boxes, extra_wlh)
    inside = inside & seeds.valid[:, None] & mask[None, :]
    # each point's first containing box (jnp.argmax of a boolean: uint8
    # keeps the first maximum)
    box_id = inside.to(torch.uint8).argmax(0)
    in_any = inside.any(0)
    s = seeds.boxes.shape[0]
    first = (torch.arange(s, device=points.device)[:, None]
             == box_id[None, :]) & in_any[None, :]
    idx, ok = first_in_box(first, max_crop_points)
    keep = torch.zeros(points.shape[0] + 1, dtype=torch.bool,
                       device=points.device)
    keep[torch.where(ok, idx, points.shape[0])] = True
    return keep[:-1]


def remove_ground(points: torch.Tensor, mask: torch.Tensor,
                  band: float = 0.2) -> torch.Tensor:
    z = points[:, 2]
    return mask & ((z < -band) | (z > band))
