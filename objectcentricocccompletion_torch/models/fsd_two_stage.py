"""Two-stage FSD (counterpart of the JAX package's
``models/fsd_two_stage.py``): the single-stage proposals are refined by
pooling raw points into each enlarged proposal box and running a SIR RoI
encoder and classification / regression heads, OcOccNet's RoI machinery
with the cluster axis in place of the tracklet's frames.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..core import boxes as box_ops
from ..core import coder
from ..ops import roi_pool as rp
from ..utils.device import resolve_device
from .fsd import FSD, FSDConfig, Grouping, fsd_loss, tiny_fsd_config
from .layers import Mlp, he_normal_, init_flax_like_
from .sir import SIREncoder

# f_cluster of a pooled point: box-local xyz (3), distances to the six
# faces (6), in the margin only (1), offset from the RoI's bottom centre (3)
ROI_GEO_DIM = 13


@dataclasses.dataclass(frozen=True)
class TwoStageFSDConfig:
    fsd: FSDConfig = dataclasses.field(default_factory=FSDConfig)
    roi_points: int = 256          # points pooled per proposal
    extra_wlh: tuple = (0.5, 0.5, 0.5)
    num_blocks: int = 3
    feat_channels: tuple = (64, 64)
    head_mlp: tuple = (256, 256)


def tiny_two_stage_config() -> TwoStageFSDConfig:
    return TwoStageFSDConfig(fsd=tiny_fsd_config(), roi_points=64,
                             num_blocks=2, feat_channels=(16, 16),
                             head_mlp=(32,))


def first_in_box(inside: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` True columns of each row of ``inside`` [R, N], in
    column order: (indices [R, k], valid [R, k]). A row with fewer reads
    index 0 in its remaining slots, which are not valid. Each True column's
    slot is the running count of Trues before it, so no sort is needed."""
    r, n = inside.shape
    rank = torch.cumsum(inside, 1) - 1
    slot = torch.where(inside & (rank < k), rank, k)
    idx = inside.new_zeros((r, k + 1), dtype=torch.long)
    idx.scatter_(1, slot, torch.arange(n, device=inside.device).expand(r, n))
    count = inside.sum(1, keepdim=True)
    return idx[:, :k], torch.arange(k, device=inside.device) < count


class TwoStageFSD(nn.Module):
    """``TwoStageFSD(cfg, device, generator)``: stage 1 is
    :class:`~.fsd.FSD` (``stage1``); built and initialised as it is."""

    def __init__(self, cfg: TwoStageFSDConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = c = cfg
        dt = getattr(torch, c.fsd.compute_dtype)
        self.stage1 = FSD(c.fsd, device="cpu")
        self.roi_encoder = SIREncoder(
            c.fsd.point_dim - 3, ROI_GEO_DIM, num_blocks=c.num_blocks,
            feat_channels=c.feat_channels, rel_mlp_hidden=(8, 16),
            xyz_normalizer=(20.0, 20.0, 4.0), geo_input=True, act="gelu",
            dtype=dt)
        d = c.num_blocks * sum(c.feat_channels)
        self.conv_cls = Mlp(d, tuple(c.head_mlp) + (1,), is_head=True,
                            act="gelu", dtype=dt)
        self.conv_reg = Mlp(d, tuple(c.head_mlp) + (coder.CODE_SIZE,),
                            is_head=True, act="gelu", dtype=dt)
        if generator is not None:
            init_flax_like_(self, generator)
            for p in self.parameters():
                if p.dim() == 3:
                    he_normal_(p, generator)
        self.to(dev)

    def select_points(self, points: torch.Tensor, mask: torch.Tensor,
                      rois: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Every point inside its enlarged proposal pools, in scan order, up
        to the per-RoI cap: (point indices [R, P], pooled [R, P]). No
        gradient flows through it."""
        c = self.cfg
        rois = rois.detach()
        inside = box_ops.points_in_boxes(points[:, :3], rois,
                                         c.extra_wlh) & mask[None]
        idx, slot_ok = first_in_box(inside, c.roi_points)
        info = rp.roi_pool(points[idx][None, ..., :3],
                           torch.ones_like(slot_ok)[None], rois[None],
                           c.extra_wlh)
        return idx, info.mask[0] & slot_ok

    def forward(self, points: torch.Tensor, mask: torch.Tensor,
                grouping: Grouping | None = None,
                selection: tuple | None = None) -> dict:
        """Stage 1's dict plus ``cls2`` [R], ``bbox2`` [R, 7],
        ``refined_boxes`` [R, 7], ``roi_nonempty`` [R] and ``rois``
        [R, 7] (stage 1's own-class boxes), R = ``max_clusters``.
        ``grouping`` goes to stage 1, ``selection`` replaces
        :meth:`select_points`'s, for a caller that holds one run against
        another from the same clusters and pooled points."""
        return self.refine(points, mask, self.stage1(points, mask, grouping),
                           selection)

    def refine(self, points: torch.Tensor, mask: torch.Tensor, out1: dict,
               selection: tuple | None = None) -> dict:
        """Stage 2 over stage 1's output dict ``out1``, whose ``boxes`` are
        the proposals: the forward's dict. A caller may hold stage 2 apart
        from stage 1 by giving it another run's proposals."""
        c = self.cfg
        rois = out1["boxes"]
        idx, pmask = selection or self.select_points(points, mask, rois)
        roi_pts = points[idx]                                # [R, P, C]
        info = rp.roi_pool(roi_pts[None, ..., :3],
                           torch.ones_like(pmask)[None], rois[None],
                           c.extra_wlh)
        f_cluster = torch.cat(
            [info.local_xyz[0], info.boundary_offset[0],
             info.is_in_margin[0][..., None], info.rel_xyz[0]], -1)
        _, feats = self.roi_encoder(roi_pts[..., :3], roi_pts[..., 3:],
                                    pmask, f_cluster)
        nonempty = pmask.any(-1) & out1["cluster_valid"]
        feats = torch.where(nonempty[:, None], feats, 0.0)
        cls2 = self.conv_cls(feats)[..., 0].float()
        reg2 = self.conv_reg(feats).float()
        return dict(out1, cls2=cls2, bbox2=reg2,
                    refined_boxes=coder.decode_from_rois(rois, reg2),
                    roi_nonempty=nonempty, rois=rois)

    def loss(self, points, mask, gt_boxes, gt_labels, gt_valid) -> dict:
        return two_stage_loss(self(points, mask), points, gt_boxes,
                              gt_labels, gt_valid)


def two_stage_loss(out: dict, points, gt_boxes, gt_labels, gt_valid,
                   pos_iou=(0.45, 0.35, 0.35),
                   cls_pos_thr=(0.8, 0.65, 0.65),
                   cls_neg_thr=(0.2, 0.15, 0.15),
                   neg_piece_fractions=(0.8, 0.2),
                   neg_iou_piece_thrs=(0.55, 0.1),
                   code_weights=(2., 2., 1., 1., 1., 1., 1.),
                   cls_weight: float = 1.0, reg_weight: float = 2.0,
                   corner_weight: float = 1.0,
                   corner_loss_only_car: bool = True) -> dict:
    """Stage 1's :func:`~.fsd.fsd_loss` plus the stage-2 losses:

    * each RoI matches the GT boxes of its own class by aligned 3D IoU and
      is positive over its class's ``pos_iou``;
    * classification against the IoU soft label between the class's
      (``cls_neg_thr``, ``cls_pos_thr``), negatives weighted so that the
      hard IoU piece [0.1, 0.55) carries 80% of their mass and the rest 20%;
    * code-weighted L1 on the canonical RoI-frame targets of the positives;
    * the corner loss (huber over the heading-flip-invariant corner
      distance) of the car positives."""
    f32 = torch.float32
    losses = fsd_loss(out, points, gt_boxes, gt_labels, gt_valid)
    rois = out["rois"]
    dev = rois.device
    n_roi = rois.shape[0]
    roi_cls = out["cluster_class"]
    ncls = out["cls"].shape[-1]
    labels = gt_labels.long()

    def per_cls(arr):
        a = list(arr) + [arr[-1]] * max(0, ncls - len(arr))
        return torch.tensor(a[:ncls], dtype=f32, device=dev)[roi_cls]

    n_gt = gt_boxes.shape[0]
    iou = box_ops.aligned_iou_3d(rois[None].expand(n_gt, n_roi, 7),
                                 gt_boxes[:, None].expand(n_gt, n_roi, 7))
    same_cls = (labels[:, None] == roi_cls[None, :]) & gt_valid[:, None]
    iou = torch.where(same_cls, iou, -1.0)                   # [G, R]
    best_iou = iou.amax(0)
    best_gt = iou.argmax(0)
    valid_roi = out["roi_nonempty"]

    p_thr, n_thr = per_cls(cls_pos_thr), per_cls(cls_neg_thr)
    soft = ((best_iou - n_thr) / (p_thr - n_thr)).clamp(0.0, 1.0)
    cls2 = out["cls2"]
    bce = (cls2.clamp(min=0) - cls2 * soft
           + torch.log1p(torch.exp(-cls2.abs())))

    pos = (best_iou > per_cls(pos_iou)) & valid_roi
    neg = ~pos & valid_roi
    hard_neg = neg & (best_iou >= neg_iou_piece_thrs[1]) \
        & (best_iou < neg_iou_piece_thrs[0])
    easy_neg = neg & ~hard_neg
    n_hard = hard_neg.to(f32).sum().clamp(min=1)
    n_easy = easy_neg.to(f32).sum().clamp(min=1)
    n_neg = neg.to(f32).sum()
    w = (pos.to(f32)
         + hard_neg.to(f32) * neg_piece_fractions[0] * n_neg / n_hard
         + easy_neg.to(f32) * neg_piece_fractions[1] * n_neg / n_easy)
    loss_cls2 = cls_weight * (bce * w).sum() / w.sum().clamp(min=1)

    gt_m = gt_boxes[best_gt]
    targets = coder.encode_roi_targets(rois, gt_m)
    l1 = (out["bbox2"] - targets).abs() * torch.tensor(
        code_weights, dtype=f32, device=dev)
    num_pos = pos.sum().clamp(min=1)
    loss_reg2 = reg_weight * (l1 * pos[:, None].to(f32)).sum() / num_pos

    loss_corner2 = torch.zeros((), dtype=f32, device=dev)
    if corner_weight > 0:
        pc = box_ops.corners_3d(coder.decode_from_rois(rois, out["bbox2"]))
        gc0 = box_ops.corners_3d(gt_m)
        flipped = torch.cat([gt_m[..., :6], gt_m[..., 6:] + math.pi], -1)
        gc1 = box_ops.corners_3d(flipped)
        dist = torch.minimum((pc - gc0).norm(dim=-1),
                             (pc - gc1).norm(dim=-1))        # [R, 8]
        quad = torch.minimum(dist, torch.ones_like(dist))
        huber = 0.5 * quad ** 2 + (dist - quad)
        cw = pos.to(f32)
        if corner_loss_only_car:
            cw = cw * (roi_cls == 0).to(f32)
        loss_corner2 = (corner_weight * (huber.mean(-1) * cw).sum()
                        / cw.sum().clamp(min=1.0))

    total = losses["loss"] + loss_cls2 + loss_reg2 + loss_corner2
    return dict(losses, loss_cls2=loss_cls2, loss_reg2=loss_reg2,
                loss_corner2=loss_corner2, loss=total,
                num_pos_rois2=pos.sum())
