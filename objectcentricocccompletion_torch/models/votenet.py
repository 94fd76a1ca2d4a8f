"""VoteNet, indoor 3D detection on PointNet++ (counterpart of the JAX
package's ``models/votenet.py``):

  * a PointNet++ SSG backbone: set-abstraction stages (furthest point
    samples as centres, ball-query groups, a shared MLP and a masked max)
    and feature propagation back to the seed level;
  * voting: every seed regresses a centre offset and a feature residual;
  * proposals: furthest point samples of the votes, ball-query aggregation
    and a head of objectness, centre refinement, log size, yaw (SUN RGB-D's
    ``with_yaw``) and class scores.

One padded frame per call, float32; the sample contract is the frame
datasets' (``data/indoor_dataset.py``), so ``training/detector_trainer.py``
and the KITTI-protocol evaluator drive it. The furthest point samples are
sequential loops on the host (``ops/pointnet.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import boxes as box_ops
from ..ops import pointnet as pn
from ..utils.device import resolve_device
from .layers import Mlp, init_flax_like_


@dataclasses.dataclass(frozen=True)
class VoteNetConfig:
    num_classes: int = 18
    max_points: int = 40000
    in_feats: int = 3                  # rgb channels after xyz
    # (npoint, radius, k, mlp widths) per set-abstraction stage
    sa_layers: Tuple = ((2048, 0.2, 64, (64, 64, 128)),
                        (1024, 0.4, 32, (128, 128, 256)),
                        (512, 0.8, 16, (128, 128, 256)),
                        (256, 1.2, 16, (128, 128, 256)))
    fp_channels: Tuple = ((256, 256), (256, 256))
    num_proposals: int = 256
    vote_mlp: Tuple[int, ...] = (256, 256)
    agg_radius: float = 0.3
    agg_k: int = 16
    agg_mlp: Tuple[int, ...] = (128, 128, 128)
    head_mlp: Tuple[int, ...] = (128, 128)
    with_yaw: bool = False             # False: ScanNet; True: SUN RGB-D
    # objectness by distance to the nearest GT centre (vote_head train_cfg)
    pos_dist: float = 0.3
    neg_dist: float = 0.6


def tiny_votenet_config(num_classes: int = 4) -> VoteNetConfig:
    return VoteNetConfig(
        num_classes=num_classes, max_points=1024, in_feats=3,
        sa_layers=((256, 0.4, 16, (16, 16)), (64, 0.8, 8, (16, 32))),
        fp_channels=((32,),), num_proposals=16, vote_mlp=(16,),
        agg_mlp=(16, 16), head_mlp=(16,), agg_k=8)


def _masked_max(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Max over the group axis of the valid rows (-1e30 where none); the
    gradient is split evenly among equal maxima, as JAX's."""
    return torch.where(valid[..., None], x, -1e30).amax(1)


class SetAbstraction(nn.Module):
    def __init__(self, in_feats: int, npoint: int, radius: float, k: int,
                 mlp: Sequence[int]):
        super().__init__()
        self.npoint, self.radius, self.k = npoint, radius, k
        self.mlp = Mlp(3 + in_feats, tuple(mlp), act="relu")

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor | None,
                mask: torch.Tensor):
        """xyz [N, 3]; feats [N, C] or None; mask [N] -> (centres [P, 3],
        features [P, C'], centre mask [P])."""
        idx = pn.furthest_point_sample(xyz, mask, self.npoint)
        centers, cmask = xyz[idx], mask[idx]
        nidx, nvalid = pn.ball_query(centers, xyz, mask, self.radius, self.k)
        grouped = xyz[nidx] - centers[:, None, :]
        if feats is not None:
            grouped = torch.cat([grouped, feats[nidx]], -1)
        x = _masked_max(self.mlp(grouped), nvalid)
        keep = cmask & nvalid.any(-1)
        return centers, torch.where(keep[:, None], x, 0.0), cmask


class FeaturePropagation(nn.Module):
    def __init__(self, in_dim: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = Mlp(in_dim, tuple(mlp), act="relu")

    def forward(self, q_xyz, q_feats, s_xyz, s_mask, s_feats):
        up = pn.three_interpolate(q_xyz, s_xyz, s_mask, s_feats)
        x = torch.cat([q_feats, up], -1) if q_feats is not None else up
        return self.mlp(x)


class VoteNet(nn.Module):
    """``VoteNet(cfg, device, generator)``: built on the CPU, its weights
    drawn from ``generator`` as flax initialises them when one is given,
    then moved to ``device`` (``cuda`` unless the caller asks for the
    CPU). Module names are the flax ones (``sa{i}.mlp``, ``fp{j}.mlp``,
    ``vote``, ``agg``, ``head``)."""

    def __init__(self, cfg: VoteNetConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = c = cfg
        dims = [c.in_feats]
        for i, (npoint, radius, k, mlp) in enumerate(c.sa_layers):
            self.add_module(f"sa{i}", SetAbstraction(dims[-1], npoint,
                                                     radius, k, mlp))
            dims.append(mlp[-1])
        s_dim = dims[-1]
        for j, mlp in enumerate(c.fp_channels):
            q_dim = dims[-2 - j]
            self.add_module(f"fp{j}", FeaturePropagation(q_dim + s_dim, mlp))
            s_dim = mlp[-1]
        self.vote = Mlp(s_dim, tuple(c.vote_mlp) + (3 + s_dim,),
                        is_head=True, act="relu")
        self.agg = Mlp(3 + s_dim, tuple(c.agg_mlp), act="relu")
        out_dim = 7 + (2 if c.with_yaw else 0) + c.num_classes
        self.head = Mlp(c.agg_mlp[-1], tuple(c.head_mlp) + (out_dim,),
                        is_head=True, act="relu")
        if generator is not None:
            init_flax_like_(self, generator)
        self.to(dev)

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> dict:
        c = self.cfg
        xyz = points[:, :3]
        feats = points[:, 3:3 + c.in_feats] if c.in_feats else None
        levels = [(xyz, feats, mask)]
        for i in range(len(c.sa_layers)):
            levels.append(getattr(self, f"sa{i}")(*levels[-1]))
        sx, sf, sm = levels[-1]
        for j in range(len(c.fp_channels)):
            qx, qf, qm = levels[-2 - j]
            sf = getattr(self, f"fp{j}")(qx, qf, sx, sm, sf)
            sx, sm = qx, qm
        seed_xyz, seed_feats, seed_mask = sx, sf, sm

        vote = self.vote(seed_feats)
        vote_xyz = torch.where(seed_mask[:, None], seed_xyz + vote[:, :3],
                               0.0)
        vote_feats = seed_feats + vote[:, 3:]

        pidx = pn.furthest_point_sample(vote_xyz, seed_mask,
                                        c.num_proposals)
        agg_xyz, agg_mask = vote_xyz[pidx], seed_mask[pidx]
        nidx, nvalid = pn.ball_query(agg_xyz, vote_xyz, seed_mask,
                                     c.agg_radius, c.agg_k)
        grouped = torch.cat([vote_xyz[nidx] - agg_xyz[:, None, :],
                             vote_feats[nidx]], -1)
        x = _masked_max(self.agg(grouped), nvalid)
        x = torch.where(agg_mask[:, None], x, 0.0)

        head = self.head(x)
        obj = head[:, 0]
        center = agg_xyz + head[:, 1:4]
        size = torch.exp(head[:, 4:7].clamp(-4.0, 3.0))
        o = 7
        if c.with_yaw:
            sn, cs = head[:, 7], head[:, 8]
            ok = sn * sn + cs * cs > 1e-12
            yaw = torch.where(ok, torch.atan2(torch.where(ok, sn, 0.0),
                                              torch.where(ok, cs, 1.0)), 0.0)
            o = 9
        else:
            yaw = torch.zeros_like(obj)
        boxes = torch.cat([center[:, :2],
                           (center[:, 2] - size[:, 2] / 2)[:, None], size,
                           yaw[:, None]], -1)
        return dict(seed_xyz=seed_xyz, seed_mask=seed_mask,
                    vote_xyz=vote_xyz, obj=obj, boxes=boxes, sem=head[:, o:],
                    proposal_mask=agg_mask)

    def loss(self, points, mask, gt_boxes, gt_labels, gt_valid) -> dict:
        """The VoteHead recipe: the vote L1 of the seeds inside a GT box
        (toward its gravity centre), objectness by distance to the nearest
        GT centre (positive below ``pos_dist``, negative above
        ``neg_dist``), and over positives the centre and log-size L1, the
        yaw's |sin| (``with_yaw``) and the class cross entropy."""
        c = self.cfg
        out = self(points, mask)
        gctr = box_ops.gravity_center(gt_boxes)

        seed = out["seed_xyz"]
        inbox = box_ops.points_in_boxes(seed[None], gt_boxes) \
            & gt_valid[:, None]                               # [M, S]
        seed_fg = inbox.any(0) & out["seed_mask"]
        vote_tgt = gctr[inbox.to(torch.uint8).argmax(0)]
        vw = seed_fg.float()
        loss_vote = ((out["vote_xyz"] - vote_tgt).abs() * vw[:, None]).sum() \
            / vw.sum().clamp(min=1)

        pb = out["boxes"]
        pctr = box_ops.gravity_center(pb)
        d2 = ((pctr[:, None] - gctr[None]) ** 2).sum(-1)
        d2 = torch.where(gt_valid[None, :], d2, 1e10)
        dmin = d2.amin(-1).sqrt()
        near_gt = d2.argmin(-1)
        pos = (dmin < c.pos_dist) & out["proposal_mask"]
        neg = (dmin > c.neg_dist) & out["proposal_mask"]
        lab = pos.float()
        w = (pos | neg).float()
        obj = out["obj"]
        bce = obj.clamp(min=0) - obj * lab + torch.log1p(torch.exp(-obj.abs()))
        loss_obj = (bce * w).sum() / w.sum().clamp(min=1)

        posf = pos.float()
        npos = posf.sum().clamp(min=1)
        tgt = gt_boxes[near_gt]
        loss_center = ((pctr - box_ops.gravity_center(tgt)).abs()
                       * posf[:, None]).sum() / npos
        loss_size = ((torch.log(pb[:, 3:6].clamp(min=1e-3))
                      - torch.log(tgt[:, 3:6].clamp(min=1e-3))).abs()
                     * posf[:, None]).sum() / npos
        loss_yaw = ((torch.sin(pb[:, 6] - tgt[:, 6]).abs() * posf).sum()
                    / npos if c.with_yaw else 0.0)

        sem_lab = F.one_hot(gt_labels[near_gt].long(), c.num_classes).float()
        logp = F.log_softmax(out["sem"], -1)
        loss_sem = -((sem_lab * logp).sum(-1) * posf).sum() / npos

        total = (loss_vote + 0.5 * loss_obj + loss_center + loss_size
                 + 0.1 * loss_yaw + 0.1 * loss_sem)
        return dict(loss_vote=loss_vote, loss_obj=loss_obj,
                    loss_center=loss_center, loss_size=loss_size,
                    loss_sem=loss_sem, loss=total, num_pos=posf.sum())

    def predict(self, points: torch.Tensor, mask: torch.Tensor):
        """(boxes [P, 7], sigmoid(objectness) x proposal mask, argmax of
        the class scores, proposal mask)."""
        out = self(points, mask)
        scores = torch.sigmoid(out["obj"]) * out["proposal_mask"]
        return (out["boxes"], scores, out["sem"].argmax(-1),
                out["proposal_mask"])
