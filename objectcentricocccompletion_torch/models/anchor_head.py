"""Anchor3DHead for SST: dense per-BEV-cell anchors, three 1x1 convs
(cls / reg / dir), and the box decode.

Counterpart of the JAX package's ``models/anchor_head.py`` (the inference
half; assignment and loss come with the training slice).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

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
