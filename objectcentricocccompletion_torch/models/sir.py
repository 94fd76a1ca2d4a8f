"""Sparse Instance Recognition (SIR) encoder (counterpart of the JAX
package's ``models/sir.py``), in three point layouts:

- dense: ``[G, P, C]`` with a ``[G, P]`` mask; the group reduce is a
  masked max over the points;
- packed-tight: ``[B, N, C]`` with per-point segment ids ``seg_ids``; a
  one-hot segment max, and a row gather back to the points;
- packed-blocked: the same with ``block_seg``, one segment per quantum
  block; a per-block max, a combine, and a per-block gather back.

All three share one parameter structure. Per block: gate the input by
``rel_mlp(f_rel)``, two VFE layers with the broadcast group max
concatenated after the first; the block's cluster feature is both group
maxima, and the cluster features of all blocks concatenate. ``dropout``
drops each VFE layer's input in a training forward (``keys`` given); no
configuration of the repo sets it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import packed as pk
from ..ops.masked import masked_max, masked_mean
from .layers import DropoutKeys, Mlp, VfeLayer


# f_rel = f_cluster / REL_DIST_SCALER (the reference's rel_dist_scaler)
REL_DIST_SCALER = 10.0


def _reciprocal(c) -> np.ndarray:
    """The float32 reciprocal of a constant: jitted XLA computes ``x / c``
    as ``x * (1 / c)``."""
    return np.float32(1.0) / np.asarray(c, np.float32)


class SIRBlock(nn.Module):
    def __init__(self, in_dim: int, rel_dim: int,
                 feat_channels: Sequence[int] = (128, 128),
                 rel_mlp_hidden: Sequence[int] = (16, 32),
                 act: str = "gelu", dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.num_vfe = len(feat_channels)
        self.rel_mlp = Mlp(rel_dim, tuple(rel_mlp_hidden) + (in_dim,),
                           act=act, dtype=dtype)
        fin = in_dim
        for i, c in enumerate(feat_channels):
            self.add_module(f"vfe_{i}", VfeLayer(fin, c, act, dtype,
                                                 dropout))
            fin = 2 * c

    def forward(self, in_feats: torch.Tensor, f_rel: torch.Tensor,
                mask: torch.Tensor, seg_ids: torch.Tensor | None = None,
                num_segments: int | None = None,
                block_seg: torch.Tensor | None = None,
                keys: DropoutKeys | None = None):
        """Returns (point_feats, cluster feats [G or B x S, sum(feat)])."""
        x = in_feats.to(self.dtype) * self.rel_mlp(f_rel, keys)
        if seg_ids is None:
            def reduce(x):
                return masked_max(x, mask, -2)

            def broadcast(g, x):
                return g[..., None, :].expand(x.shape)
        elif block_seg is not None:
            def reduce(x):
                return pk.segment_max_blocked(x, mask, block_seg,
                                              num_segments)

            def broadcast(g, x):
                return pk.broadcast_back_blocked(g, block_seg, x.shape[1])
        else:
            def reduce(x):
                return pk.segment_max(x, seg_ids, num_segments)

            def broadcast(g, x):
                return pk.broadcast_back(g, seg_ids)

        cluster = []
        for i in range(self.num_vfe):
            x = getattr(self, f"vfe_{i}")(x, keys)
            g = reduce(x)
            cluster.append(g)
            if i != self.num_vfe - 1:
                x = torch.cat([x, broadcast(g, x)], -1)
        return x, torch.cat(cluster, -1)


class SIREncoder(nn.Module):
    """A stack of SIR blocks in either wiring.

    ``geo_input=True`` (the RoI encoder): block input = [xyz / normaliser,
    point feats, f_rel]; no shortcut. ``geo_input=False`` (the occupancy
    AE): block input = [xyz / normaliser, point feats]; ``f_cluster``
    defaults to the group-mean-centred xyz; a block whose input feats have
    the output's shape adds them (the shortcut). ``f_rel`` is ``f_cluster
    / REL_DIST_SCALER``.

    ``feat_dim`` is the width of ``feats``, ``rel_dim`` that of
    ``f_cluster`` (3 when it defaults).
    """

    def __init__(self, feat_dim: int, rel_dim: int = 3, num_blocks: int = 6,
                 feat_channels: Sequence[int] = (128, 128),
                 rel_mlp_hidden: Sequence[int] = (16, 32),
                 xyz_normalizer: Sequence[float] = (1.0, 1.0, 1.0),
                 geo_input: bool = False, act: str = "gelu",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.num_blocks = num_blocks
        # the divisions by the normaliser and the scaler as jitted XLA runs
        # them; the normaliser is a constant on the module's device
        self.register_buffer("inv_xyz_normalizer", torch.from_numpy(
            _reciprocal(xyz_normalizer)), persistent=False)
        self.inv_rel_dist_scaler = float(_reciprocal(REL_DIST_SCALER))
        self.geo_input = geo_input
        width = feat_dim
        for i in range(num_blocks):
            in_dim = 3 + width + (rel_dim if geo_input else 0)
            self.add_module(f"block_{i}", SIRBlock(
                in_dim, rel_dim, feat_channels, rel_mlp_hidden, act, dtype,
                dropout))
            width = feat_channels[-1]

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor,
                mask: torch.Tensor, f_cluster: torch.Tensor | None = None,
                seg_ids: torch.Tensor | None = None,
                num_segments: int | None = None,
                block_seg: torch.Tensor | None = None,
                keys: DropoutKeys | None = None):
        """Dense: xyz [G, P, 3], feats [G, P, F], mask [G, P] ->
        (point feats [G, P, C], roi feats [G, num_blocks * sum(feat)]).
        Packed (``seg_ids`` [B, N] given): leading dims [B, N]; roi feats
        [B, num_segments, ...]."""
        xyz_n = xyz * self.inv_xyz_normalizer.to(xyz.dtype)
        if f_cluster is None:
            if seg_ids is None:
                center = masked_mean(xyz, mask, -2)
                f_cluster = xyz - center[..., None, :]
            elif block_seg is not None:
                center = pk.segment_mean_blocked(xyz, mask, block_seg,
                                                 num_segments)
                f_cluster = xyz - pk.broadcast_back_blocked(
                    center, block_seg, xyz.shape[1])
            else:
                center = pk.segment_mean(xyz, seg_ids, num_segments)
                f_cluster = xyz - pk.broadcast_back(center, seg_ids)
        f_rel = f_cluster * self.inv_rel_dist_scaler

        out_feats = feats
        cluster = []
        for i in range(self.num_blocks):
            parts = [xyz_n, out_feats] + ([f_rel] if self.geo_input else [])
            point_feats, c = getattr(self, f"block_{i}")(
                torch.cat(parts, -1), f_rel, mask, seg_ids, num_segments,
                block_seg, keys)
            if not self.geo_input and out_feats.shape == point_feats.shape:
                point_feats = point_feats + out_feats
            out_feats = point_feats
            cluster.append(c)
        return out_feats, torch.cat(cluster, -1)
