"""Anchor3DHead for SST: dense per-BEV-cell anchors, three 1x1 convs
(cls / reg / dir), MaxIoU assignment on nearest-yaw BEV IoU, the focal /
L1 / direction losses, and the box decode.

Counterpart of the JAX package's ``models/anchor_head.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core import coder
from .layers import conv


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    sizes: Sequence[Sequence[float]] = ((2.08, 4.73, 1.77),)
    # per-size anchor bottom z, stored as configured
    z_centers: Sequence[float] = (-0.0345,)
    rotations: Sequence[float] = (0.0, 1.5707963)
    # scalar, or one threshold per size/class
    pos_iou_thr: float | Sequence[float] = 0.55
    neg_iou_thr: float | Sequence[float] = 0.4
    dir_offset: float = 0.7854


def waymo_3class_anchor_config() -> AnchorConfig:
    """The 3-class Waymo anchors and per-class assigner thresholds: car,
    cyclist, pedestrian."""
    return AnchorConfig(
        sizes=((2.08, 4.73, 1.77), (0.84, 1.81, 1.77), (0.84, 0.91, 1.74)),
        z_centers=(-0.0345, -0.1188, 0.0),
        pos_iou_thr=(0.55, 0.5, 0.5),
        neg_iou_thr=(0.4, 0.3, 0.3))


def generate_anchors(hw: tuple, pc_range, cfg: AnchorConfig) -> np.ndarray:
    """[GX*GY*S*R, 7] float32 anchors aligned to BEV cells, in numpy.

    Axis 0 of ``hw`` indexes X cells and axis 1 Y cells; the flat order is
    (x, y, size, rotation), matching :class:`AnchorHead`'s reshape of the
    channel-last [GX, GY, n*K] map."""
    GX, GY = hw
    xs = np.linspace(pc_range[0], pc_range[3], GX, endpoint=False) \
        + (pc_range[3] - pc_range[0]) / GX / 2
    ys = np.linspace(pc_range[1], pc_range[4], GY, endpoint=False) \
        + (pc_range[4] - pc_range[1]) / GY / 2
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    out = []
    for size, zc in zip(cfg.sizes, cfg.z_centers):
        for rot in cfg.rotations:
            a = np.zeros((GX, GY, 7), np.float32)
            a[..., 0] = gx
            a[..., 1] = gy
            a[..., 2] = zc
            a[..., 3:6] = size
            a[..., 6] = rot
            out.append(a.reshape(-1, 7))
    return np.stack(out, 1).reshape(-1, 7)


class AnchorHead(nn.Module):
    """Three plain 1x1 convs reading the neck features; cls bias starts at
    -log(99) = -4.59 (prior probability 0.01)."""

    def __init__(self, in_channels: int, num_classes: int = 1,
                 num_anchors_per_cell: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors_per_cell = n = num_anchors_per_cell
        self.dtype = dtype
        self.cls = nn.Conv2d(in_channels, n * num_classes, 1)
        self.reg = nn.Conv2d(in_channels, n * 7, 1)
        self.dir = nn.Conv2d(in_channels, n * 2, 1)
        self.reset_cls_bias()

    def reset_cls_bias(self) -> None:
        with torch.no_grad():
            self.cls.bias.fill_(-4.59)

    def forward(self, bev: torch.Tensor):
        """bev [1, C, GX, GY] -> cls [A, ncls], reg [A, 7], dir [A, 2] with
        A = GX * GY * n, in the computation dtype."""
        def head(layer, k):
            y = conv(layer, bev, self.dtype)[0].permute(1, 2, 0)
            return y.reshape(-1, k)
        return (head(self.cls, self.num_classes), head(self.reg, 7),
                head(self.dir, 2))


def nearest_bev_iou(anchors: torch.Tensor, gts: torch.Tensor
                    ) -> torch.Tensor:
    """[A, 7] x [G, 7] -> [A, G] axis-aligned BEV IoU after turning each box
    to its nearest axis (w and l swap where |sin yaw| > |cos yaw|)."""
    def to_aabb(b):
        swap = torch.sin(b[:, 6]).abs() > torch.cos(b[:, 6]).abs()
        w = torch.where(swap, b[:, 4], b[:, 3])
        l = torch.where(swap, b[:, 3], b[:, 4])
        return (b[:, 0] - w / 2, b[:, 1] - l / 2,
                b[:, 0] + w / 2, b[:, 1] + l / 2)

    ax0, ay0, ax1, ay1 = to_aabb(anchors)
    gx0, gy0, gx1, gy1 = to_aabb(gts)
    ix = (torch.minimum(ax1[:, None], gx1[None])
          - torch.maximum(ax0[:, None], gx0[None])).clamp(min=0)
    iy = (torch.minimum(ay1[:, None], gy1[None])
          - torch.maximum(ay0[:, None], gy0[None])).clamp(min=0)
    inter = ix * iy
    aa = (ax1 - ax0) * (ay1 - ay0)
    ga = (gx1 - gx0) * (gy1 - gy0)
    return inter / (aa[:, None] + ga[None] - inter).clamp(min=1e-6)


def _per_class(thr, anchor_classes, device) -> torch.Tensor | float:
    if anchor_classes is None or not isinstance(thr, (list, tuple)):
        return float(thr)
    return torch.tensor(thr, dtype=torch.float32, device=device)[
        anchor_classes]


def assign(anchors: torch.Tensor, gt_boxes: torch.Tensor,
           gt_labels: torch.Tensor, gt_valid: torch.Tensor,
           cfg: AnchorConfig, anchor_classes: torch.Tensor | None = None):
    """Returns (matched gt index [A] int64, pos mask [A], neg mask [A]).

    Each anchor takes its best GT by IoU (the first on ties); IoU >=
    ``pos_iou_thr`` is positive, < ``neg_iou_thr`` negative. With
    ``anchor_classes`` the matching is restricted to the anchor's class and
    the thresholds are per class. Then each GT claims its best anchor
    (forced match, the first anchor on ties). Where several GTs claim one
    anchor, the last GT by index wins, valid or not (padded GTs, whose IoU
    is -1 everywhere, all claim anchor 0): the order in which the JAX
    package's scatter applies its updates on the CPU, here made
    deterministic on every device."""
    iou = nearest_bev_iou(anchors, gt_boxes)
    iou = torch.where(gt_valid[None], iou, -1.0)
    if anchor_classes is not None:
        same = anchor_classes[:, None] == gt_labels[None, :].long()
        iou = torch.where(same, iou, -1.0)
    pos_thr = _per_class(cfg.pos_iou_thr, anchor_classes, iou.device)
    neg_thr = _per_class(cfg.neg_iou_thr, anchor_classes, iou.device)
    best_iou = iou.amax(1)
    best_gt = iou.argmax(1)           # the first index on ties
    pos = best_iou >= pos_thr
    # anchors with no candidate GT (none valid, or none of their class) are
    # background
    neg = best_iou < neg_thr
    best_anchor = iou.argmax(0)
    G = gt_boxes.shape[0]
    last = torch.full((anchors.shape[0],), -1, dtype=torch.long,
                      device=iou.device)
    last.scatter_reduce_(0, best_anchor,
                         torch.arange(G, device=iou.device), "amax")
    claimed = last >= 0
    forced_gt = last.clamp(min=0)
    forced = claimed & gt_valid[forced_gt]
    best_gt = torch.where(forced & ~pos, forced_gt, best_gt)
    pos = pos | forced
    neg = neg & ~pos
    return best_gt, pos, neg


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss."""
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


def _floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.mod``: the remainder of a truncating division, moved into the
    divisor's sign (``torch.remainder`` rounds differently)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def anchor_head_loss(cls_logits: torch.Tensor, reg_pred: torch.Tensor,
                     dir_pred: torch.Tensor, anchors: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_valid: torch.Tensor, acfg: AnchorConfig,
                     num_classes: int = 1, cls_weight: float = 1.0,
                     bbox_weight: float = 0.5, dir_weight: float = 0.2
                     ) -> dict:
    """Focal classification over positive and negative anchors, L1 on the
    delta targets of positives with the sin-difference heading term
    (|sin(p - t)|), and direction cross-entropy over positives, each
    normalised by the positive count (at least 1)."""
    anchor_classes = None
    if len(acfg.sizes) > 1:
        # anchor flat order is (cell, size, rotation); sizes map 1:1 to
        # classes
        R = len(acfg.rotations)
        a = torch.arange(cls_logits.shape[0], device=cls_logits.device)
        anchor_classes = (a // R) % len(acfg.sizes)
    best_gt, pos, neg = assign(anchors, gt_boxes, gt_labels, gt_valid, acfg,
                               anchor_classes)
    matched = gt_boxes[best_gt]
    matched_lab = gt_labels[best_gt].long()

    # one-hot for positives (a label outside the classes gives zeros, as
    # jax.nn.one_hot does), zeros for negatives, the rest ignored
    classes = torch.arange(num_classes, device=cls_logits.device)
    tgt = ((matched_lab[:, None] == classes) & pos[:, None]).to(
        cls_logits.dtype)
    wt = (pos | neg).to(cls_logits.dtype)[:, None]
    num_pos = pos.sum().to(cls_logits.dtype).clamp(min=1.0)
    loss_cls = cls_weight * (focal_loss(cls_logits, tgt) * wt).sum() \
        / num_pos

    deltas = coder.encode(anchors, matched)
    rp, rt = reg_pred[:, 6], deltas[:, 6]
    pred = torch.cat([reg_pred[:, :6],
                      (torch.sin(rp) * torch.cos(rt))[:, None]], -1)
    deltas = torch.cat([deltas[:, :6],
                        (torch.cos(rp) * torch.sin(rt))[:, None]], -1)
    l1 = (pred - deltas).abs()
    posf = pos.to(l1.dtype)
    loss_bbox = bbox_weight * (l1 * posf[:, None]).sum() / num_pos

    rot = matched[:, 6] - acfg.dir_offset
    dir_tgt = (_floor_mod(rot, 2 * math.pi) >= math.pi).long()
    logp = F.log_softmax(dir_pred, -1)
    dir_ce = -logp.gather(-1, dir_tgt[:, None])[:, 0]
    loss_dir = dir_weight * (dir_ce * posf).sum() / num_pos

    total = loss_cls + loss_bbox + loss_dir
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_dir=loss_dir,
                loss=total, num_pos_anchors=pos.sum())


def anchor_head_decode(cls_logits: torch.Tensor, reg_pred: torch.Tensor,
                       dir_pred: torch.Tensor, anchors: torch.Tensor,
                       acfg: AnchorConfig, max_out: int = 500,
                       score_thr: float = 0.1):
    """Top ``max_out`` anchors by score -> (boxes [K, 7], scores [K],
    labels [K], valid [K]). Ties keep the lower anchor index first, as
    ``jax.lax.top_k`` does."""
    scores = torch.sigmoid(cls_logits)
    best, labels = scores.max(-1)
    top, idx = torch.sort(best, descending=True, stable=True)
    top, idx = top[:max_out], idx[:max_out]
    boxes = coder.decode(anchors[idx], reg_pred[idx])
    dirs = dir_pred[idx].argmax(-1)
    yaw = torch.remainder(boxes[:, 6] - acfg.dir_offset, math.pi) \
        + acfg.dir_offset + math.pi * dirs
    boxes = torch.cat([boxes[:, :6], yaw[:, None]], -1)
    return boxes, top, labels[idx], top > score_thr
