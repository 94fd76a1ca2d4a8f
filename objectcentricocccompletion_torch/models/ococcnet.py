"""OcOccNet: tracklet box refinement and object-centric occupancy
completion (counterpart of the JAX package's ``models/ococcnet.py``; the
serving path: ``OcOccNetWithLoss.predict`` and ``decode_occ_queries``).

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

Training (the losses, dropout, the optimizer) is the next slice of the
port: ``OcOccNetWithLoss.__call__``, ``train=True`` with a nonzero dropout,
``use_segmentor`` and ``remat_sir`` raise ``NotImplementedError``.
"""
from __future__ import annotations

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
from .layers import Mlp, init_flax_like_, sinusoidal_position_encoding
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
                                is_head=True, act=cfg.act, dtype=dt)
            self.conv_reg = Mlp(roi_dim, tuple(cfg.reg_mlp)
                                + (coder.CODE_SIZE,), is_head=True,
                                act=cfg.act, dtype=dt)
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
                                        dtype=dt)
        self.conv_latent = Mlp(roi_dim + D, tuple(cfg.latent_mlp) + (D,),
                               is_head=True, act=cfg.act, dtype=dt)
        self.conv_fused = Mlp(D + (D if cfg.rcnn_trans else roi_dim),
                              tuple(cfg.fusion_mlp) + (D,), is_head=True,
                              act=cfg.act, dtype=dt)
        self.conv_cls = Mlp(D, tuple(cfg.cls_mlp) + (1,), is_head=True,
                            act=cfg.act, dtype=dt)
        self.conv_reg = Mlp(D, tuple(cfg.reg_mlp) + (coder.CODE_SIZE,),
                            is_head=True, act=cfg.act, dtype=dt)
        self.occ_decoder = OccDecoder(D, cfg.occ_mlp, cfg.pos_encode_freqs,
                                      cfg.act, cfg.occ_pos_thresh, dt)

    def _check_train(self, train: bool) -> None:
        if train and any(r > 0 for r in _dropouts(self.cfg)):
            raise NotImplementedError(
                "train=True with a nonzero dropout: dropout is ported with "
                "the training slice (OcOccNet losses and optimizer)")

    def forward(self, batch: TrackletBatch, train: bool = False) -> dict:
        self._check_train(train)
        cfg = self.cfg
        B, L, P, _ = batch.points.shape
        G = B * L
        pts_xyz = batch.points[..., :3]
        pts_feats = batch.points[..., 3:]
        layout = self.point_layout(batch)
        pool, order = layout.pool, layout.order
        if layout.packed is not None:
            roi_feats, ae_feats, nonempty = self._encode_packed(
                batch, pool, layout.packed, pts_xyz, pts_feats)
            return self._heads(batch, roi_feats, ae_feats, nonempty, train)

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
                                        flat(pool.mask), flat(f_cluster))
        roi_feats = torch.where(nonempty[..., None],
                                roi_feats.reshape(B, L, -1), 0.0)
        if not self.with_occ:
            return self._heads(batch, roi_feats, None, nonempty, train)

        vox = rp.quantize_to_voxel_centers(pool.local_xyz,
                                           batch.rois[..., 3:6],
                                           cfg.ae_voxel_size)
        ae_in = torch.cat([pts_feats[..., :2], pool.boundary_offset,
                           pool.is_in_margin[..., None], vox], -1)
        _, ae_feats = self.ae_encoder(flat(pool.local_xyz), flat(ae_in),
                                      flat(pool.mask))
        ae_feats = torch.where(nonempty[..., None],
                               ae_feats.reshape(B, L, -1), 0.0)
        return self._heads(batch, roi_feats, ae_feats, nonempty, train)

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
                       pts_feats: torch.Tensor):
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
                                        f_cluster, seg, L, bseg)
        roi_feats = torch.where(nonempty[..., None], roi_feats, 0.0)
        if not self.with_occ:
            return roi_feats, None, nonempty

        vox = rp.quantize_to_voxel_centers_aligned(
            p_local, bb(batch.rois[..., 3:6]), cfg.ae_voxel_size)
        ae_in = torch.cat([p_feats[..., :2], p_boundary, p_margin, vox], -1)
        _, ae_feats = self.ae_encoder(p_local, ae_in, packed.valid, None,
                                      seg, L, bseg)
        ae_feats = torch.where(nonempty[..., None], ae_feats, 0.0)
        return roi_feats, ae_feats, nonempty

    def _heads(self, batch: TrackletBatch, roi_feats: torch.Tensor,
               ae_feats: torch.Tensor | None, nonempty: torch.Tensor,
               train: bool) -> dict:
        cfg = self.cfg
        if not self.with_occ:
            return dict(cls_logit=self.conv_cls(roi_feats)[..., 0].float(),
                        bbox_pred=self.conv_reg(roi_feats).float(),
                        shape_latent=roi_feats, ae_latent=roi_feats,
                        nonempty=nonempty)
        pos = (sinusoidal_position_encoding(batch.frame_inds, cfg.d_model)
               + self.roi_pos_enc(batch.rois))
        window = -1 if train else cfg.test_attn_window
        fused = self.temporal(roi_feats, pos, causal=True, window=window)
        shape_latent = self.conv_latent(
            torch.cat([ae_feats, fused], -1)).float()
        rcnn_in = fused if cfg.rcnn_trans else roi_feats
        rcnn_feats = self.conv_fused(torch.cat([shape_latent, rcnn_in], -1))
        return dict(cls_logit=self.conv_cls(rcnn_feats)[..., 0].float(),
                    bbox_pred=self.conv_reg(rcnn_feats).float(),
                    shape_latent=shape_latent, ae_latent=ae_feats,
                    nonempty=nonempty)

    def decode_occ(self, shape_latent: torch.Tensor, queries: torch.Tensor,
                   train: bool = False) -> torch.Tensor:
        """Occupancy logits for box-local ``queries`` [..., K, 3] given
        ``shape_latent`` [..., D]."""
        self._check_train(train)
        return self.occ_decoder(shape_latent, queries)


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
        if generator is not None:
            init_flax_like_(self, generator)
        self.to(dev)

    def forward(self, batch: TrackletBatch, train: bool = True):
        raise NotImplementedError(
            "the OcOccNet losses are the next slice of the port (losses, "
            "gradients, optimizer); use predict / decode_occ_queries")

    def predict(self, batch: TrackletBatch) -> dict:
        """Refined boxes, scores and the network's outputs."""
        out = self.net(batch, train=False)
        boxes = coder.decode_from_rois(batch.rois, out["bbox_pred"])
        scores = torch.sigmoid(out["cls_logit"])
        return dict(boxes=boxes, scores=scores, **out)

    def decode_occ_queries(self, latent: torch.Tensor, queries: torch.Tensor
                           ) -> torch.Tensor:
        return self.net.decode_occ(latent, queries, train=False)
