"""OcOccNet: tracklet box refinement and object-centric occupancy
completion (counterpart of the JAX package's ``models/ococcnet.py``: the
losses of ``OcOccNetWithLoss.forward``, ``predict`` and
``decode_occ_queries``).

One tracklet is ``L`` frames, each with one RoI box and at most ``P``
points. The forward:
  1. pool each frame's points into its RoI (13-d geometry per point);
  2. the RoI encoder, 6 SIR blocks over [xyz, point feats, geometry], gives
     a per-frame observation feature;
  3. the occupancy AE encoder, 6 SIR blocks over box-local coords, face
     distances and snapped voxel centres, gives a local shape latent;
  4. a causal temporal transformer over the frames (sinusoidal frame
     encoding plus an MLP encoding of the RoI box);
  5. fusion MLPs and the cls / reg heads; the implicit occupancy decoder
     reads the fused shape latent.
Points run in one of three layouts: dense ``[B, L, P]``, dense compacted to
``roi_point_budget`` points per RoI, or packed (``ops/packed.py``, the
config default). ``variant="ctrl"`` is the CTRL baseline: the RoI encoder
and the heads only.

A training forward (``train=True``) runs the full causal window and, where
the config's dropout rates are nonzero, the counter-hash dropout of
``models/layers.py`` with the keys the caller passes (``DropoutKeys``).
``use_segmentor`` and ``remat_sir`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..configs.ococcnet_config import OcOccNetConfig
from ..core import boxes as box_ops
from ..core import coder
from ..data.tracklet import TrackletBatch
from ..ops import packed as pk
from ..ops import roi_pool as rp
from ..utils.device import resolve_device
from .layers import (DropoutKeys, Mlp, init_flax_like_,
                     sinusoidal_position_encoding)
from .occ_decoder import OccDecoder
from .sir import SIREncoder
from .transformer import TemporalEncoder

# per-point geometry of the RoI encoder's f_cluster: local xyz (3), face
# distances (6), in-margin flag (1), offset from the RoI bottom (3)
GEO_DIM = 13
# the AE's per-point input: 2 point feats, face distances (6), in-margin
# flag (1), snapped voxel centre (3)
AE_FEAT_DIM = 12


class PointLayout(NamedTuple):
    """Each frame's points pooled into its RoI, and how the model lays
    them out: the packing (packed layout), or the dense compaction's
    per-RoI point order (None where the budget does not bind)."""
    pool: rp.RoiPoolInfo                # [B, L, P]
    packed: pk.PackedPoints | None      # [B, N]
    order: torch.Tensor | None          # [B, L, Q]

    def kept(self) -> torch.Tensor:
        """The mask of the layout's slots that hold a point."""
        if self.packed is not None:
            return self.packed.valid
        if self.order is not None:
            return torch.gather(self.pool.mask, 2, self.order)
        return self.pool.mask


def _dropouts(cfg: OcOccNetConfig) -> list[float]:
    return [cfg.occ_dropout, cfg.attn_dropout, cfg.cls_dropout,
            cfg.reg_dropout, cfg.latent_dropout, cfg.fusion_dropout]


class OcOccNet(nn.Module):
    """Built on the CPU with default PyTorch initialisation; the entry
    point :class:`OcOccNetWithLoss` draws its weights and moves it."""

    def __init__(self, cfg: OcOccNetConfig):
        super().__init__()
        if cfg.use_segmentor:
            raise NotImplementedError(
                "use_segmentor (TrackletSegmentor point features) is not "
                "ported yet")
        if cfg.remat_sir:
            raise NotImplementedError(
                "remat_sir (rematerialised SIR encoders in training) is not "
                "ported yet")
        self.cfg = cfg
        dt = getattr(torch, cfg.compute_dtype)
        self.dtype = dt
        # a constant on the module's device (no host-to-device copy per call)
        self.register_buffer("extra_wlh", torch.tensor(cfg.extra_wlh),
                             persistent=False)
        self.with_occ = cfg.variant == "ococc"
        roi_dim = cfg.num_blocks * sum(cfg.feat_channels)
        self.roi_encoder = SIREncoder(
            cfg.num_point_feats + 1, GEO_DIM, cfg.num_blocks,
            cfg.feat_channels, cfg.rel_mlp_hidden, cfg.xyz_normalizer,
            geo_input=True, act=cfg.act, dtype=dt)
        if not self.with_occ:
            self.conv_cls = Mlp(roi_dim, tuple(cfg.cls_mlp) + (1,),
                                is_head=True, act=cfg.act, dtype=dt,
                                dropout=cfg.cls_dropout)
            self.conv_reg = Mlp(roi_dim, tuple(cfg.reg_mlp)
                                + (coder.CODE_SIZE,), is_head=True,
                                act=cfg.act, dtype=dt,
                                dropout=cfg.reg_dropout)
            return
        D = cfg.d_model
        self.ae_encoder = SIREncoder(
            AE_FEAT_DIM, 3, cfg.num_blocks, cfg.feat_channels,
            cfg.rel_mlp_hidden, cfg.ae_xyz_normalizer, geo_input=False,
            act=cfg.act, dtype=dt)
        self.roi_pos_enc = Mlp(7, tuple(cfg.roi_pos_enc_mlp) + (D,),
                               is_head=True, act=cfg.act, dtype=dt)
        self.temporal = TemporalEncoder(D, cfg.num_enc_layers,
                                        cfg.attn_num_heads, cfg.attn_ffn_dim,
                                        dtype=dt,
                                        attn_dropout=cfg.attn_dropout)
        self.conv_latent = Mlp(roi_dim + D, tuple(cfg.latent_mlp) + (D,),
                               is_head=True, act=cfg.act, dtype=dt,
                               dropout=cfg.latent_dropout)
        self.conv_fused = Mlp(D + (D if cfg.rcnn_trans else roi_dim),
                              tuple(cfg.fusion_mlp) + (D,), is_head=True,
                              act=cfg.act, dtype=dt,
                              dropout=cfg.fusion_dropout)
        self.conv_cls = Mlp(D, tuple(cfg.cls_mlp) + (1,), is_head=True,
                            act=cfg.act, dtype=dt, dropout=cfg.cls_dropout)
        self.conv_reg = Mlp(D, tuple(cfg.reg_mlp) + (coder.CODE_SIZE,),
                            is_head=True, act=cfg.act, dtype=dt,
                            dropout=cfg.reg_dropout)
        self.occ_decoder = OccDecoder(D, cfg.occ_mlp, cfg.pos_encode_freqs,
                                      cfg.act, cfg.occ_pos_thresh, dt,
                                      dropout=cfg.occ_dropout)

    def _keys(self, train: bool, keys: DropoutKeys | None
              ) -> DropoutKeys | None:
        """The keys the dropout sites draw from: None outside training; a
        training forward with a nonzero rate needs them."""
        if not train:
            return None
        if keys is None and any(r > 0 for r in _dropouts(self.cfg)):
            raise ValueError("a training forward with a nonzero dropout "
                             "needs its DropoutKeys")
        return keys

    def forward(self, batch: TrackletBatch, train: bool = False,
                keys: DropoutKeys | None = None) -> dict:
        """The network's outputs; ``train``: the full causal window and,
        with ``keys``, dropout."""
        keys = self._keys(train, keys)
        cfg = self.cfg
        B, L, P, _ = batch.points.shape
        G = B * L
        pts_xyz = batch.points[..., :3]
        pts_feats = batch.points[..., 3:]
        layout = self.point_layout(batch)
        pool, order = layout.pool, layout.order
        if layout.packed is not None:
            roi_feats, ae_feats, nonempty = self._encode_packed(
                batch, pool, layout.packed, pts_xyz, pts_feats, keys)
            return self._heads(batch, roi_feats, ae_feats, nonempty, train,
                               keys)

        if order is not None:
            def take(x):
                if x.dim() == 3:
                    return torch.gather(x, 2, order)
                return torch.gather(x, 2, order[..., None].expand(
                    order.shape + x.shape[-1:]))

            pts_xyz, pts_feats = take(pts_xyz), take(pts_feats)
            pool = rp.RoiPoolInfo(*(take(x) for x in pool))
            P = order.shape[-1]

        nonempty = pool.mask.any(-1)                        # [B, L]

        def flat(x):
            return x.reshape((G,) + x.shape[2:])

        roi_score = batch.roi_scores[..., None, None].expand(B, L, P, 1)
        enc_feats = torch.cat([pts_feats, roi_score], -1)
        f_cluster = torch.cat([pool.local_xyz, pool.boundary_offset,
                               pool.is_in_margin[..., None], pool.rel_xyz],
                              -1)
        _, roi_feats = self.roi_encoder(flat(pts_xyz), flat(enc_feats),
                                        flat(pool.mask), flat(f_cluster),
                                        keys=keys)
        roi_feats = torch.where(nonempty[..., None],
                                roi_feats.reshape(B, L, -1), 0.0)
        if not self.with_occ:
            return self._heads(batch, roi_feats, None, nonempty, train, keys)

        vox = rp.quantize_to_voxel_centers(pool.local_xyz,
                                           batch.rois[..., 3:6],
                                           cfg.ae_voxel_size)
        ae_in = torch.cat([pts_feats[..., :2], pool.boundary_offset,
                           pool.is_in_margin[..., None], vox], -1)
        _, ae_feats = self.ae_encoder(flat(pool.local_xyz), flat(ae_in),
                                      flat(pool.mask), keys=keys)
        ae_feats = torch.where(nonempty[..., None],
                               ae_feats.reshape(B, L, -1), 0.0)
        return self._heads(batch, roi_feats, ae_feats, nonempty, train, keys)

    def point_layout(self, batch: TrackletBatch) -> PointLayout:
        """Pool each frame's points into its RoI and lay them out. Packed:
        the valid pooled points of all frames in one [B, N] buffer, N the
        budget set at ``reg_len`` frames scaled to the tracklet's length
        and rounded up to the quantum. Dense: each RoI's valid pooled
        points first (a stable sort keeps their order), cut to
        ``roi_point_budget``."""
        cfg = self.cfg
        pool = rp.roi_pool(batch.points[..., :3], batch.points_mask,
                           batch.rois, self.extra_wlh)
        L, P = pool.mask.shape[1:]
        if cfg.packed_point_budget:
            q = cfg.packed_quantum
            N = L * max(cfg.packed_point_budget // cfg.reg_len, q or 1)
            if q:
                packed = pk.pack_groups_aligned(pool.mask, -(-N // q) * q, q)
            else:
                packed = pk.pack_groups(pool.mask, N)
            return PointLayout(pool, packed, None)
        Q = cfg.roi_point_budget
        if Q and Q < P:
            order = torch.argsort((~pool.mask).to(torch.int32), dim=-1,
                                  stable=True)[..., :Q]
            return PointLayout(pool, None, order)
        return PointLayout(pool, None, None)

    def _encode_packed(self, batch: TrackletBatch, pool: rp.RoiPoolInfo,
                       packed: pk.PackedPoints, pts_xyz: torch.Tensor,
                       pts_feats: torch.Tensor, keys: DropoutKeys | None):
        """The encoders on the packed layout, with frame segment ids."""
        cfg = self.cfg
        L = batch.rois.shape[1]
        N = packed.valid.shape[1]
        seg, bseg = packed.seg_ids, packed.block_seg

        # one row gather for every per-point channel
        pc = pk.pack_rows(torch.cat(
            [pts_xyz, pts_feats, pool.local_xyz, pool.boundary_offset,
             pool.is_in_margin[..., None], pool.rel_xyz], -1), packed.order)
        F = pts_feats.shape[-1]
        o = 3 + F
        p_xyz, p_feats = pc[..., 0:3], pc[..., 3:o]
        p_local, p_boundary = pc[..., o:o + 3], pc[..., o + 3:o + 9]
        p_margin, p_rel = pc[..., o + 9:o + 10], pc[..., o + 10:o + 13]
        nonempty = pk.segment_any(seg, L)                   # [B, L]

        def bb(table):
            # per-frame rows to the points: one gather per block if aligned
            if bseg is not None:
                return pk.broadcast_back_blocked(table, bseg, N)
            return pk.broadcast_back(table, seg)

        enc_feats = torch.cat([p_feats, bb(batch.roi_scores[..., None])], -1)
        f_cluster = torch.cat([p_local, p_boundary, p_margin, p_rel], -1)
        _, roi_feats = self.roi_encoder(p_xyz, enc_feats, packed.valid,
                                        f_cluster, seg, L, bseg, keys)
        roi_feats = torch.where(nonempty[..., None], roi_feats, 0.0)
        if not self.with_occ:
            return roi_feats, None, nonempty

        vox = rp.quantize_to_voxel_centers_aligned(
            p_local, bb(batch.rois[..., 3:6]), cfg.ae_voxel_size)
        ae_in = torch.cat([p_feats[..., :2], p_boundary, p_margin, vox], -1)
        _, ae_feats = self.ae_encoder(p_local, ae_in, packed.valid, None,
                                      seg, L, bseg, keys)
        ae_feats = torch.where(nonempty[..., None], ae_feats, 0.0)
        return roi_feats, ae_feats, nonempty

    def _heads(self, batch: TrackletBatch, roi_feats: torch.Tensor,
               ae_feats: torch.Tensor | None, nonempty: torch.Tensor,
               train: bool, keys: DropoutKeys | None) -> dict:
        cfg = self.cfg
        if not self.with_occ:
            return dict(
                cls_logit=self.conv_cls(roi_feats, keys)[..., 0].float(),
                bbox_pred=self.conv_reg(roi_feats, keys).float(),
                shape_latent=roi_feats, ae_latent=roi_feats,
                nonempty=nonempty)
        pos = (sinusoidal_position_encoding(batch.frame_inds, cfg.d_model)
               + self.roi_pos_enc(batch.rois, keys))
        window = -1 if train else cfg.test_attn_window
        fused = self.temporal(roi_feats, pos, causal=True, window=window,
                              keys=keys)
        shape_latent = self.conv_latent(
            torch.cat([ae_feats, fused], -1), keys).float()
        rcnn_in = fused if cfg.rcnn_trans else roi_feats
        rcnn_feats = self.conv_fused(torch.cat([shape_latent, rcnn_in], -1),
                                     keys)
        return dict(cls_logit=self.conv_cls(rcnn_feats, keys)[..., 0].float(),
                    bbox_pred=self.conv_reg(rcnn_feats, keys).float(),
                    shape_latent=shape_latent, ae_latent=ae_feats,
                    nonempty=nonempty)

    def decode_occ(self, shape_latent: torch.Tensor, queries: torch.Tensor,
                   train: bool = False, keys: DropoutKeys | None = None
                   ) -> torch.Tensor:
        """Occupancy logits for box-local ``queries`` [..., K, 3] given
        ``shape_latent`` [..., D]."""
        return self.occ_decoder(shape_latent, queries,
                                self._keys(train, keys))


def gt_occ_to_roi_frame(occ_points: torch.Tensor, gt_boxes: torch.Tensor,
                        rois: torch.Tensor) -> torch.Tensor:
    """GT-box-frame occupancy samples [B, K, 3] into each RoI's local frame:
    gt_boxes, rois [B, L, 7] -> [B, L, K, 3]."""
    ego = box_ops.local_to_global(occ_points[:, None], gt_boxes)
    return box_ops.box_local_coords(ego, rois)


class OcOccNetWithLoss(nn.Module):
    """``OcOccNetWithLoss(cfg, device, generator)``: the network under
    ``net``, built on the CPU, its weights drawn from ``generator`` (flax's
    default init) when one is given, then moved to ``device`` (``cuda``
    unless the caller asks for the CPU)."""

    def __init__(self, cfg: OcOccNetConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.net = OcOccNet(cfg)
        # the box code's loss weights on the device (no copy per step)
        self.register_buffer("code_weights", torch.tensor(
            cfg.rcnn_code_weights, dtype=torch.float32), persistent=False)
        if generator is not None:
            init_flax_like_(self, generator)
        self.to(dev)

    def forward(self, batch: TrackletBatch, train: bool = True,
                keys: DropoutKeys | None = None):
        """``(total, losses)``: the reference's loss terms and metrics, 0-d
        float32 tensors on the batch's device.

        - ``loss_rcnn_cls``: BCE of the classification logit against the
          IoU-soft label, over the RoIs that hold points, divided by B * L;
        - ``loss_rcnn_bbox``: the code-weighted L1 of the box residuals
          over positives (GT present and RoI not empty), divided by
          ``max(num_pos, 1)``;
        - ``loss_rcnn_corner`` (``ctrl`` only; 0 where its weight is 0):
          the Huber of each corner's distance to the nearer of the GT's and
          its heading-flipped twin's, mean over corners, over positives;
        - ``loss_rcnn_occ`` (``ococc`` only): BCE of the occupancy logits
          of the GT samples in each RoI's frame, weighted by positive x
          (annotation score > threshold) x sample mask, divided by
          ``max(num_pos * K, 1)``; then the metrics."""
        cfg = self.cfg
        out = self.net(batch, train=train, keys=keys)
        B, L = out["cls_logit"].shape
        iou = box_ops.aligned_iou_3d(batch.rois, batch.gt_boxes)
        iou = torch.where(batch.gt_valid, iou, 0.0)

        soft = ((iou - cfg.cls_neg_thr)
                / (cfg.cls_pos_thr - cfg.cls_neg_thr)).clamp(0.0, 1.0)
        cls_w = out["nonempty"].float()
        bce = _bce_with_logits(out["cls_logit"], soft)
        loss_cls = cfg.loss_cls_weight * (bce * cls_w).sum() / float(B * L)

        posf = (batch.gt_valid & out["nonempty"]).float()
        num_pos = posf.sum()
        pos_den = num_pos.clamp(min=1.0)
        targets = coder.encode_roi_targets(batch.rois, batch.gt_boxes)
        l1 = (out["bbox_pred"] - targets).abs() * self.code_weights
        loss_bbox = (cfg.loss_bbox_weight * (l1 * posf[..., None]).sum()
                     / pos_den)

        loss_corner = torch.zeros((), device=posf.device)
        if cfg.corner_loss_weight > 0:
            pc = box_ops.corners_3d(
                coder.decode_from_rois(batch.rois, out["bbox_pred"]))
            gt_flip = batch.gt_boxes.clone()
            gt_flip[..., 6] += math.pi
            dist = torch.minimum(
                torch.linalg.vector_norm(
                    pc - box_ops.corners_3d(batch.gt_boxes), dim=-1),
                torch.linalg.vector_norm(
                    pc - box_ops.corners_3d(gt_flip), dim=-1))  # [B, L, 8]
            quad = dist.clamp(max=1.0)
            huber = 0.5 * quad ** 2 + (dist - quad)
            loss_corner = (cfg.corner_loss_weight
                           * (huber.mean(-1) * posf).sum() / pos_den)

        if cfg.variant != "ococc":
            total = loss_cls + loss_bbox + loss_corner
            return total, dict(loss_rcnn_cls=loss_cls,
                               loss_rcnn_bbox=loss_bbox,
                               loss_rcnn_corner=loss_corner, loss=total,
                               num_pos_rois=num_pos)

        queries = gt_occ_to_roi_frame(batch.occ_points, batch.gt_boxes,
                                      batch.rois)             # [B, L, K, 3]
        occ_logits = self.net.decode_occ(out["shape_latent"], queries,
                                         train=train, keys=keys)
        occ_lab = (batch.occ_labels == 1)[:, None].expand(
            occ_logits.shape).float()
        conf = (batch.occ_score > cfg.occ_label_thresh).float()
        occ_w = (posf[..., None] * conf[:, None, None]
                 * batch.occ_mask[:, None].float())
        K = occ_logits.shape[-1]
        occ_bce = _bce_with_logits(occ_logits, occ_lab)
        loss_occ = (cfg.loss_occ_weight * (occ_bce * occ_w).sum()
                    / (num_pos * K).clamp(min=1.0))
        total = loss_cls + loss_bbox + loss_occ + loss_corner
        losses = dict(loss_rcnn_cls=loss_cls, loss_rcnn_bbox=loss_bbox,
                      loss_rcnn_occ=loss_occ, loss=total)
        return total, {**losses, **_metrics(out, soft, cls_w, occ_logits,
                                            occ_lab, occ_w, num_pos)}

    def predict(self, batch: TrackletBatch) -> dict:
        """Refined boxes, scores and the network's outputs."""
        out = self.net(batch, train=False)
        boxes = coder.decode_from_rois(batch.rois, out["bbox_pred"])
        scores = torch.sigmoid(out["cls_logit"])
        return dict(boxes=boxes, scores=scores, **out)

    def decode_occ_queries(self, latent: torch.Tensor, queries: torch.Tensor
                           ) -> torch.Tensor:
        return self.net.decode_occ(latent, queries, train=False)


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
    """Binary cross entropy with probabilistic targets, in the stable form
    of the JAX package: max(x, 0) - x t + log1p(exp(-|x|))."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _safe_mean(num_mask: torch.Tensor, den_mask: torch.Tensor
               ) -> torch.Tensor:
    return num_mask.float().sum() / den_mask.float().sum().clamp(min=1.0)


def _metrics(out, soft, cls_w, occ_logits, occ_lab, occ_w, num_pos) -> dict:
    """The reference's training metrics (no gradient flows through them)."""
    with torch.no_grad():
        valid = cls_w > 0
        pred_pos = torch.sigmoid(out["cls_logit"]) > 0.5
        acc = _safe_mean((pred_pos == (soft > 0.5)) & valid, valid)
        occ_pred = torch.sigmoid(occ_logits) > 0.5
        occ_valid = occ_w > 0
        occ_pos = occ_lab > 0.5
        return dict(
            num_pos_rois=num_pos.detach(), cls_acc=acc,
            occ_recall_pos=_safe_mean(occ_pred & occ_pos & occ_valid,
                                      occ_pos & occ_valid),
            occ_recall_neg=_safe_mean(~occ_pred & ~occ_pos & occ_valid,
                                      ~occ_pos & occ_valid),
            occ_frac_occupied=_safe_mean(occ_pos & occ_valid, occ_valid))
