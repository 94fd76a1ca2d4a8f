"""CenterPoint detection head: class heatmaps and per-pixel box regression,
its targets, losses and top-K peak decoding (counterpart of the JAX
package's ``models/centerpoint_head.py``).

The head computes on NCHW maps and returns each map as an ``[H, W, C]``
view, the JAX package's layout: the targets, the loss's gather at the GT
centres and the decode's flattening (``idx % ncls`` is the class) read them
in that order. Targets render every gaussian at once ([max_objs, H, W]) and
max-reduce them per class.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.routes import relu
from .second import _gn, group_norm

HEAD_CONVS = 2  # convolutions per head branch (the last one biased)
SHARE_CHANNELS = 64
HEATMAP_INIT_BIAS = -2.19
# the targets' gaussians: radius floor and the overlap the radius keeps
MIN_RADIUS = 2.0
GAUSSIAN_OVERLAP = 0.1
# L1 weights of the 10 box codes (velocity off) and of the box loss
CODE_WEIGHTS = (1., 1., 1., 1., 1., 1., 1., 1., 0., 0.)
BBOX_WEIGHT = 2.0
SCORE_THRESHOLD = 0.1


def head_dims(num_classes: int) -> dict:
    """Branch name -> output channels, in the JAX package's call order
    (which numbers the auto-named norms)."""
    return dict(heatmap=num_classes, reg=2, height=1, dim=3, rot=2, vel=2)


class SeparateHead(nn.Module):
    def __init__(self, in_channels: int, head_dims: dict):
        super().__init__()
        self.head_dims = dict(head_dims)
        self.shared = nn.Conv2d(in_channels, SHARE_CHANNELS, 3, padding=1,
                                bias=False)
        self.GroupNorm_0 = _gn(SHARE_CHANNELS)
        k = 1
        for name, c in self.head_dims.items():
            for i in range(HEAD_CONVS - 1):
                self.add_module(f"{name}_conv{i}", nn.Conv2d(
                    SHARE_CHANNELS, 64, 3, padding=1, bias=False))
                self.add_module(f"GroupNorm_{k}", _gn(64))
                k += 1
            self.add_module(f"{name}_out", nn.Conv2d(64, c, 3, padding=1))

    def reset_heatmap_bias(self) -> None:
        """The heatmap branch's prior bias (the other biases stay 0)."""
        with torch.no_grad():
            self.heatmap_out.bias.fill_(HEATMAP_INIT_BIAS)

    def forward(self, x: torch.Tensor) -> dict:
        """x [1, C, H, W] -> name -> [1, c, H, W]."""
        x = relu(group_norm(self.GroupNorm_0, self.shared(x)))
        out, k = {}, 1
        for name in self.head_dims:
            h = x
            for i in range(HEAD_CONVS - 1):
                h = getattr(self, f"{name}_conv{i}")(h)
                h = relu(group_norm(getattr(self, f"GroupNorm_{k}"), h))
                k += 1
            out[name] = getattr(self, f"{name}_out")(h)
        return out


class CenterHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 1):
        super().__init__()
        self.task0 = SeparateHead(in_channels, head_dims(num_classes))

    def forward(self, bev: torch.Tensor) -> dict:
        """bev [1, C, H, W] -> name -> [H, W, c] (views of NCHW maps)."""
        return {k: v[0].permute(1, 2, 0) for k, v in self.task0(bev).items()}


# ------------------------------------------------------------------ targets
def gaussian_radius(l: torch.Tensor, w: torch.Tensor,
                    min_overlap: float = GAUSSIAN_OVERLAP) -> torch.Tensor:
    """The reference's three-case radius (``core/utils/gaussian.py:56-85``),
    elementwise. Like the reference (mmdet3d's CornerNet variant) it
    divides every root by 2, not by 2a: reproduced as it is."""
    a1 = 1.0
    b1 = l + w
    c1 = w * l * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * a1 * c1).clamp(min=0))) / 2
    a2 = 4.0
    b2 = 2 * (l + w)
    c2 = (1 - min_overlap) * w * l
    r2 = (b2 + torch.sqrt((b2 ** 2 - 4 * a2 * c2).clamp(min=0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (l + w)
    c3 = (min_overlap - 1) * w * l
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def make_targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                 gt_valid: torch.Tensor, hw: tuple, num_classes: int,
                 voxel_size, pc_range, out_size_factor: int):
    """gt_boxes [M, 7(+2)], gt_labels [M], gt_valid [M] -> heatmap
    [H, W, ncls], box targets [M, 10], centre index (iy, ix) [M, 2] int64,
    mask [M] (valid and inside the grid)."""
    H, W = hw
    dev = gt_boxes.device
    vx = voxel_size[0] * out_size_factor
    vy = voxel_size[1] * out_size_factor
    cx = (gt_boxes[:, 0] - pc_range[0]) / vx
    cy = (gt_boxes[:, 1] - pc_range[1]) / vy
    ix = torch.floor(cx).long()
    iy = torch.floor(cy).long()
    mask = gt_valid & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)

    dl = gt_boxes[:, 4] / vy     # l along y
    dw = gt_boxes[:, 3] / vx
    radius = torch.floor(gaussian_radius(dl, dw)).clamp(min=MIN_RADIUS)

    # every gaussian at once, [M, H, W]: sigma = (2 r + 1) / 6, support cut
    # to the radius window (the reference's draw_heatmap_gaussian)
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    dx = (xx - ix[:, None, None]).float()
    dy = (yy - iy[:, None, None]).float()
    r = radius[:, None, None]
    sigma = (2.0 * r + 1.0) / 6.0
    g = torch.exp(-(dx ** 2 + dy ** 2) / (2 * sigma ** 2))
    window = (dx.abs() <= r) & (dy.abs() <= r)
    g = torch.where(window & mask[:, None, None], g, 0.0)
    # the per-class max; a class without boxes stays 0 (g >= 0)
    lab = gt_labels.long().clamp(0, num_classes - 1)
    heatmap = g.new_zeros((num_classes, H * W)).scatter_reduce(
        0, lab[:, None].expand(-1, H * W), g.reshape(-1, H * W), "amax")

    h = gt_boxes[:, 5]
    rot = gt_boxes[:, 6]
    vel = (gt_boxes[:, 7:9] if gt_boxes.shape[1] >= 9
           else gt_boxes.new_zeros((gt_boxes.shape[0], 2)))
    anno = torch.cat([
        torch.stack([cx - ix, cy - iy, gt_boxes[:, 2] + h / 2], -1),
        torch.log(gt_boxes[:, 3:6].clamp(min=1e-3)),
        torch.sin(rot)[:, None], torch.cos(rot)[:, None], vel], -1)
    return (heatmap.reshape(num_classes, H, W).permute(1, 2, 0), anno,
            torch.stack([iy, ix], -1), mask)


def gaussian_focal_loss(pred_logits: torch.Tensor, heatmap: torch.Tensor
                        ) -> torch.Tensor:
    """The reference's GaussianFocalLoss (penalty-reduced focal loss with
    alpha 2 and gamma 4, mean over the positives)."""
    alpha, gamma = 2.0, 4.0
    p = torch.sigmoid(pred_logits)
    eps = 1e-6
    pos = (heatmap >= 1.0 - 1e-4).to(p.dtype)
    neg_w = torch.pow(1 - heatmap, gamma)
    pos_loss = -torch.log(p + eps) * torch.pow(1 - p, alpha) * pos
    neg_loss = (-torch.log(1 - p + eps) * torch.pow(p, alpha) * neg_w
                * (1 - pos))
    num_pos = pos.sum().clamp(min=1.0)
    return (pos_loss.sum() + neg_loss.sum()) / num_pos


def center_head_loss(preds: dict, gt_boxes, gt_labels, gt_valid,
                     voxel_size, pc_range, out_size_factor) -> dict:
    H, W, ncls = preds["heatmap"].shape
    heatmap, anno, centers, mask = make_targets(
        gt_boxes, gt_labels, gt_valid, (H, W), ncls, voxel_size, pc_range,
        out_size_factor)
    loss_hm = gaussian_focal_loss(preds["heatmap"], heatmap)

    pred_cat = torch.cat([preds["reg"], preds["height"], preds["dim"],
                          preds["rot"], preds["vel"]], -1)   # [H, W, 10]
    # centres of boxes outside the grid are out of range: clamped (JAX's
    # gather clamps them too), and the mask zeroes their terms
    at = pred_cat[centers[:, 0].clamp(0, H - 1), centers[:, 1].clamp(0, W - 1)]
    cw = torch.tensor(CODE_WEIGHTS, dtype=at.dtype, device=at.device)
    l1 = (at - anno).abs() * cw
    m = mask.to(at.dtype)
    num = m.sum().clamp(min=1.0)
    loss_bbox = BBOX_WEIGHT * (l1 * m[:, None]).sum() / num
    return dict(loss_heatmap=loss_hm, loss_bbox=loss_bbox,
                loss=loss_hm + loss_bbox)


# ------------------------------------------------------------------ decode
def decode(preds: dict, voxel_size, pc_range, out_size_factor: int,
           max_out: int = 500):
    """Top-K peak decoding (the reference's ``CenterPointBBoxCoder.decode``)
    -> boxes [K, 9], scores [K], labels [K] int64, valid [K], with K =
    min(max_out, H * W * ncls). Beyond the peaks the zeros tie, and
    ``torch.topk`` orders ties otherwise than ``lax.top_k``; no zero is
    valid."""
    H, W, ncls = preds["heatmap"].shape
    heat = torch.sigmoid(preds["heatmap"])
    # 3x3 max-pool NMS (the pool pads with -inf)
    pooled = F.max_pool2d(heat.permute(2, 0, 1)[None], 3, 1, 1)[0]
    heat = torch.where(heat == pooled.permute(1, 2, 0), heat, 0.0)
    flat = heat.reshape(-1)       # HWC order
    scores, idx = torch.topk(flat, min(max_out, flat.shape[0]))
    cls = idx % ncls
    pix = idx // ncls
    iy = pix // W
    ix = pix % W

    reg = preds["reg"][iy, ix]
    height = preds["height"][iy, ix, 0]
    dim = torch.exp(preds["dim"][iy, ix])
    rot = torch.atan2(preds["rot"][iy, ix, 0], preds["rot"][iy, ix, 1])
    vel = preds["vel"][iy, ix]

    x = (ix + reg[:, 0]) * voxel_size[0] * out_size_factor + pc_range[0]
    y = (iy + reg[:, 1]) * voxel_size[1] * out_size_factor + pc_range[1]
    z = height - dim[:, 2] / 2    # gravity -> bottom centre
    boxes = torch.cat([torch.stack([x, y, z], -1), dim, rot[:, None], vel],
                      -1)
    return boxes, scores, cls, scores > SCORE_THRESHOLD
