"""Delta-XYZWLHR box coder, the canonical RoI-frame targets and FSD's
base-point coder (counterpart of the JAX package's ``core/coder.py``).
Boxes are ``[..., 7]`` (x, y, z_bottom, w, l, h, yaw)."""
from __future__ import annotations

import math

import torch

from . import boxes as box_ops

CODE_SIZE = 7


def encode(anchors: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Deltas taking ``anchors`` to ``targets``; boxes are bottom-centre."""
    xa, ya, za, wa, la, ha, ra = anchors.split(1, -1)
    xg, yg, zg, wg, lg, hg, rg = targets.split(1, -1)
    za = za + ha / 2
    zg = zg + hg / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    return torch.cat([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
                      torch.log(wg / wa), torch.log(lg / la),
                      torch.log(hg / ha), rg - ra], -1)


def decode(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    xa, ya, za, wa, la, ha, ra = anchors.split(1, -1)
    xt, yt, zt, wt, lt, ht, rt = deltas.split(1, -1)
    za = za + ha / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    hg = torch.exp(ht) * ha
    return torch.cat([xt * diag + xa, yt * diag + ya, zt * ha + za - hg / 2,
                      torch.exp(wt) * wa, torch.exp(lt) * la, hg, rt + ra],
                     -1)


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod`` for a positive ``y``: the exact ``fmod`` moved into
    [0, y) (``torch.remainder`` rounds ``x - y * floor(x / y)`` instead)."""
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def canonical_yaw_target(rel_yaw: torch.Tensor) -> torch.Tensor:
    """Flip-invariant heading target in (-pi/2, pi/2]: opposite-facing
    boxes flip by pi, then wrap and clamp."""
    two_pi = 2 * math.pi
    ry = _mod(rel_yaw, two_pi)
    opposite = (ry > math.pi * 0.5) & (ry < math.pi * 1.5)
    ry = torch.where(opposite, _mod(ry + math.pi, two_pi), ry)
    ry = torch.where(ry > math.pi, ry - two_pi, ry)
    return ry.clamp(-math.pi / 2, math.pi / 2)


def _roi_anchor(rois: torch.Tensor) -> torch.Tensor:
    """A zero-centred, zero-yaw anchor with the RoI's sizes."""
    zeros = torch.zeros_like(rois[..., 0:1])
    return torch.cat([zeros.expand(rois[..., 0:3].shape), rois[..., 3:6],
                      zeros], -1)


def encode_roi_targets(rois: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Regression targets of GT boxes against RoIs, both ``[..., 7]``: the
    GT centre in the RoI frame rotated by -(roi_yaw + pi/2), the
    flip-canonical relative yaw, delta-encoded against :func:`_roi_anchor`.
    """
    roi_yaw = _mod(rois[..., 6], 2 * math.pi)
    rel_ctr = box_ops.rotate_z(
        (gt[..., 0:3] - rois[..., 0:3])[..., None, :],
        -(roi_yaw[..., None] + math.pi / 2))[..., 0, :]
    rel_yaw = canonical_yaw_target(gt[..., 6] - roi_yaw)
    gt_ct = torch.cat([rel_ctr, gt[..., 3:6], rel_yaw[..., None]], -1)
    return encode(_roi_anchor(rois), gt_ct)


def decode_from_rois(rois: torch.Tensor, deltas: torch.Tensor
                     ) -> torch.Tensor:
    """Inverse of :func:`encode_roi_targets`: deltas -> ego-frame boxes."""
    local = decode(_roi_anchor(rois), deltas)
    ctr = box_ops.rotate_z(local[..., None, 0:3],
                           rois[..., None, 6] + math.pi / 2)[..., 0, :]
    ctr = ctr + rois[..., 0:3]
    yaw = local[..., 6:7] + rois[..., 6:7]
    return torch.cat([ctr, local[..., 3:6], yaw], -1)


POINT_EPS = 1e-6


def point_encode(boxes: torch.Tensor, base_points: torch.Tensor
                 ) -> torch.Tensor:
    """FSD's regression target of a box against its cluster's base point:
    [delta xyz, log sizes, sin yaw, cos yaw] (8 values)."""
    delta = boxes[..., :3] - base_points
    log_dims = torch.log(boxes[..., 3:6] + POINT_EPS)
    yaw = boxes[..., 6:7]
    return torch.cat([delta, log_dims, torch.sin(yaw), torch.cos(yaw)], -1)


def point_decode(reg: torch.Tensor, base_points: torch.Tensor
                 ) -> torch.Tensor:
    """Inverse of :func:`point_encode`. The yaw's atan2 reads (0, 1) where
    sin and cos are both 0, so its gradient stays finite there."""
    xyz = reg[..., :3] + base_points
    dims = torch.exp(reg[..., 3:6]) - POINT_EPS
    sn, cs = reg[..., 6], reg[..., 7]
    ok = sn * sn + cs * cs > 1e-12
    yaw = torch.where(ok, torch.atan2(torch.where(ok, sn, 0.0),
                                      torch.where(ok, cs, 1.0)), 0.0)
    return torch.cat([xyz, dims, yaw[..., None]], -1)
