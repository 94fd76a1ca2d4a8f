"""SST single-stage detector: SST backbone + dilated-conv neck +
Anchor3DHead (counterpart of the JAX package's ``models/sst_detector.py``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from ..utils.device import resolve_device
from . import anchor_head as ah
from .layers import conv, init_flax_like_
from .sst import SST, SSTConfig, tiny_sst_config

NECK_DILATIONS = (1, 1, 2)


@dataclasses.dataclass(frozen=True)
class SSTDetectorConfig:
    sst: SSTConfig = dataclasses.field(default_factory=SSTConfig)
    anchors: ah.AnchorConfig = dataclasses.field(
        default_factory=ah.AnchorConfig)
    num_classes: int = 1
    neck_channels: int = 384
    max_gt: int = 128


def tiny_sst_detector_config() -> SSTDetectorConfig:
    return SSTDetectorConfig(sst=tiny_sst_config(), neck_channels=64,
                             max_gt=8)


class SSTDetector(nn.Module):
    """``SSTDetector(cfg, device, generator)``: built on the CPU, its
    weights drawn from ``generator`` (flax's default init) when one is
    given, then moved to ``device`` (``cuda`` unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: SSTDetectorConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        c = cfg.sst
        self.dtype = getattr(torch, c.compute_dtype)
        self.backbone = SST(c)
        chans = [c.d_model] + [cfg.neck_channels] * len(NECK_DILATIONS)
        self.neck_convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, padding=d, dilation=d,
                      bias=False)
            for i, d in enumerate(NECK_DILATIONS))
        self.neck_norms = nn.ModuleList(
            nn.GroupNorm(16, cfg.neck_channels, eps=1e-3)
            for _ in NECK_DILATIONS)
        n_anchor = len(cfg.anchors.sizes) * len(cfg.anchors.rotations)
        self.head = ah.AnchorHead(cfg.neck_channels, cfg.num_classes,
                                  n_anchor, dtype=self.dtype)
        gx, gy, _ = (int(g) for g in c.grid_shape)
        self.register_buffer(
            "anchors", torch.from_numpy(ah.generate_anchors(
                (gx, gy), c.pc_range, cfg.anchors)), persistent=False)
        if generator is not None:
            init_flax_like_(self, generator)
            self.head.reset_cls_bias()
        self.to(dev)

    def neck(self, bev: torch.Tensor) -> torch.Tensor:
        """bev [GX, GY, C] -> [1, neck_channels, GX, GY] in the computation
        dtype; GroupNorm statistics in float32 over the single sample."""
        x = bev.to(self.dtype).permute(2, 0, 1)[None]
        for cv, gn in zip(self.neck_convs, self.neck_norms):
            x = conv(cv, x, self.dtype)
            x = F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias,
                             gn.eps).to(self.dtype)
            x = torch.relu(x)
        return x

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> dict:
        """points [N, 3+F] float32, mask [N] bool -> dict of float32 cls
        [A, ncls], reg [A, 7], dir [A, 2] and ``bev_hw``."""
        feat = self.neck(self.backbone(points, mask))
        cls, reg, dirc = self.head(feat)
        return dict(cls=cls.float(), reg=reg.float(), dir=dirc.float(),
                    bev_hw=tuple(feat.shape[2:]))

    def loss(self, points: torch.Tensor, mask: torch.Tensor,
             gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
             gt_valid: torch.Tensor) -> dict:
        """One frame's losses: points [N, 3+F], mask [N], gt_boxes [M, 7],
        gt_labels [M], gt_valid [M] -> dict of float32 scalars ``loss_cls``,
        ``loss_bbox``, ``loss_dir``, ``loss`` and the count
        ``num_pos_anchors``."""
        out = self(points, mask)
        return ah.anchor_head_loss(out["cls"], out["reg"], out["dir"],
                                   self.anchors, gt_boxes, gt_labels,
                                   gt_valid, self.cfg.anchors,
                                   self.cfg.num_classes)

    def predict(self, points: torch.Tensor, mask: torch.Tensor,
                max_out: int = 500):
        """-> (boxes [K, 7], scores [K], labels [K], valid [K])."""
        out = self(points, mask)
        return ah.anchor_head_decode(out["cls"], out["reg"], out["dir"],
                                     self.anchors, self.cfg.anchors,
                                     max_out)
