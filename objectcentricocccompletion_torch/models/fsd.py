"""FSD, the fully sparse single-stage multi-class detector (counterpart of
the JAX package's ``models/fsd.py``), and FSDv2 (``use_clustering=False``).

  1. segmentation: dynamic voxelization -> DynamicVFE -> sparse UNet ->
     per-point features -> a head of per-class foreground logits and
     per-class centre votes [N, ncls, 3];
  2. per class: the ``max_fg_per_class`` best-scoring points (a stable
     descending sort: among equal scores the lower index first, as
     ``lax.top_k``), those over the class's threshold shifted by their
     vote;
  3. per class: the shifted points voxelized at the class's cluster voxel
     size, voxels of fewer than ``min_points`` dropped, and connected
     components linking voxels whose mean centres lie within the class's
     ``connected_dist`` in the xy-plane (``ops/cluster.py``);
  4. a SIR backbone over the clusters in segment form, whose cluster
     descriptor is every block's two maxima;
  5. a shared MLP and one head per class (score, centre, size, rotation);
     boxes decode against each cluster's mean vote centre.

FSDv2 replaces 3-4: the shifted points and the original ones voxelize
together at ``virtual_voxel_size``, two submanifold convolutions mix them,
and every voxel holding a class-c virtual point is a class-c instance.

Every shape is static: per-class budgets of foreground points, cluster
voxels and clusters, with validity masks. The stages are methods
(:meth:`FSD.segment`, :meth:`FSD.group`, :meth:`FSD.cluster_forward`), so
that one stage can be fed another's output. Gathers on the differentiable
path are ``index_select``s (``ops/masked.py::gather_rows``), whose CUDA
backward does not serialise repeated rows. Scores are ``torch.sigmoid``,
which may differ from XLA's logistic in the last bit.

Module and parameter names are the flax ones; the UNet's strided kernels
are ``[27, Cin, Cout]`` parameters ``unet.down{i}``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import boxes as box_ops
from ..core import coder
from ..ops import cluster as cl
from ..ops import sparse_conv as sc
from ..ops import voxelize as vx
from ..ops.masked import gather_rows, segment_max, segment_sum
from ..utils.device import resolve_device
from .layers import (LN_EPS, Mlp, VfeLayer, he_normal_, init_flax_like_,
                     layer_norm_one_pass)
from .sparse_encoder import GatherCtx, SparseBasicBlock, SubMConv
from .sir import _reciprocal
from .sst import POINT_DIM
from .vfe import DynamicVFE

# LayerNorm epsilon of the seg head and the cluster head: the reference's
# norm_cfg=dict(type='LN') carries no eps, so torch's default
HEAD_LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class FSDConfig:
    # classes (configs/fsd/fsd_waymoD1_1x.py:9)
    class_names: Tuple[str, ...] = ("Car", "Pedestrian", "Cyclist")

    # segmentor (seg_voxel_size / point_cloud_range, fsd_waymoD1_1x.py:7-8)
    voxel_size: Sequence[float] = (0.32, 0.32, 0.6)
    pc_range: Sequence[float] = (-74.88, -74.88, -2.0, 74.88, 74.88, 4.0)
    max_points: int = 160000
    max_voxels: int = 40000
    vfe_channels: Sequence[int] = (64, 64)
    unet_channels: Sequence[int] = (64, 64, 128)   # per level
    seg_head_hidden: Sequence[int] = (128, 128)    # VoteSegHead hidden_dims

    # per-class sampling + clustering (fsd_waymoD1_1x.py:10,273-289)
    seg_score_thresh: Tuple[float, ...] = (0.3, 0.25, 0.25)
    max_fg_per_class: int = 4096
    cluster_voxel_size: Tuple[Tuple[float, float, float], ...] = (
        (0.3, 0.3, 6.0), (0.05, 0.05, 6.0), (0.2, 0.2, 6.0))
    connected_dist: Tuple[float, ...] = (0.6, 0.1, 0.4)
    min_points: int = 2
    max_clusters_per_class: int = 128
    max_cluster_voxels: int = 512     # per-class voxel budget for clustering

    # SIR backbone (fsd_waymoD1_1x.py:99-110)
    sir_blocks: int = 3
    sir_channels: Tuple[int, int] = (128, 128)
    rel_mlp_hidden: Tuple[int, int] = (16, 32)
    xyz_normalizer: Tuple[float, float, float] = (20.0, 20.0, 4.0)

    # SparseClusterHeadV2 (fsd_waymoD1_1x.py:112-140)
    shared_mlp: Tuple[int, ...] = (1024, 1024)
    head_hidden: int = 128
    head_layers: int = 2

    # losses (fsd_waymoD1_1x.py:70-84,115-124)
    seg_focal_gamma: float = 3.0
    seg_focal_alpha: float = 0.8
    seg_weight: float = 1.0
    vote_weight: float = 1.0
    cls_focal_gamma: float = 2.0
    cls_focal_alpha: float = 0.25
    cls_weight: float = 2.0
    center_weight: float = 0.5
    size_weight: float = 0.5
    rot_weight: float = 0.2

    # computation dtype of the VFE / UNet / SIR / head Dense layers and
    # convolutions (parameters, LayerNorm statistics, losses and the box
    # decode stay float32)
    compute_dtype: str = "float32"

    # True = FSD (per-class connected-component clusters); False = FSDv2
    # virtual voxels (single_stage_fsd_v2.py:37)
    use_clustering: bool = True
    virtual_proj_hidden: Tuple[int, ...] = (64, 64)   # FSDv2 projector
    # FSDv2 virtual-voxel grid + mixer (single_stage_fsd_v2.py:85-230)
    virtual_voxel_size: Tuple[float, float, float] = (0.4, 0.4, 0.4)
    max_virtual_voxels: int = 8192
    virtual_mixer_channels: int = 64

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def max_clusters(self) -> int:
        return self.num_classes * self.max_clusters_per_class

    @property
    def grid_shape(self) -> tuple:
        return _grid_shape(self.pc_range, self.voxel_size)


def tiny_fsd_config(num_classes: int = 3) -> FSDConfig:
    names = ("Car", "Pedestrian", "Cyclist")[:num_classes]
    return FSDConfig(
        class_names=names,
        voxel_size=(0.8, 0.8, 1.2),
        pc_range=(-9.6, -9.6, -2.0, 9.6, 9.6, 2.8),
        max_points=4096, max_voxels=2048, vfe_channels=(16, 16),
        unet_channels=(16, 32, 32), seg_head_hidden=(32,),
        seg_score_thresh=(0.3, 0.25, 0.25)[:num_classes],
        max_fg_per_class=256,
        cluster_voxel_size=((0.5, 0.5, 4.8), (0.2, 0.2, 4.8),
                            (0.4, 0.4, 4.8))[:num_classes],
        connected_dist=(0.6, 0.2, 0.4)[:num_classes],
        max_clusters_per_class=16, max_cluster_voxels=128,
        sir_blocks=2, sir_channels=(32, 32), rel_mlp_hidden=(8, 16),
        shared_mlp=(64,), head_hidden=32,
        virtual_voxel_size=(0.8, 0.8, 1.2), max_virtual_voxels=1024,
        virtual_mixer_channels=16, virtual_proj_hidden=(16, 16))


def _grid_shape(pc_range, voxel_size, at_least_one: bool = False) -> tuple:
    g = np.round((np.asarray(pc_range[3:]) - np.asarray(pc_range[:3]))
                 / np.asarray(voxel_size))
    if at_least_one:
        g = np.maximum(g, 1)
    return tuple(int(x) for x in g)


def _top_scores(score: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the ``k`` largest values and their indices, equal
    values in index order."""
    s, idx = torch.sort(score, descending=True, stable=True)
    return s[:k], idx[:k]


class SparseUNet(nn.Module):
    """Symmetric sparse UNet: per level a SubM conv and a basic block, a
    stride-2 sparse convolution (``down{i}``, then LayerNorm and ReLU, not
    masked) before each level past the first; the decoder gathers each
    fine voxel's parent ((c + 1) // 2), concatenates it to the skip and
    applies a SubM conv. Returns the finest level's features."""

    def __init__(self, in_channels: int,
                 channels: Sequence[int] = (64, 64, 128),
                 max_voxels: int = 40000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels = tuple(channels)
        self.max_voxels = max_voxels
        self.dtype = dtype
        cin = in_channels
        for i, c in enumerate(self.channels):
            if i > 0:
                self.register_parameter(
                    f"down{i}", nn.Parameter(torch.zeros(27, cin, c)))
                self.add_module(f"down{i}_norm", nn.LayerNorm(c, eps=LN_EPS))
            self.add_module(f"enc{i}_conv", SubMConv(
                cin if i == 0 else c, c, dtype))
            self.add_module(f"enc{i}_block", SparseBasicBlock(c, c, dtype))
            cin = c
        for i in range(len(self.channels) - 2, -1, -1):
            self.add_module(f"dec{i}_conv", SubMConv(
                self.channels[i] + self.channels[i + 1], self.channels[i],
                dtype))

    def lattices(self, coords: torch.Tensor, valid: torch.Tensor,
                 grid_shape):
        """Yields per level ``(grid, s_table)``: the level's grid and, from
        level 1 on, the strided conv's table into the previous level's grid
        (None at level 0)."""
        grid = sc.build_grid(coords, valid, grid_shape)
        yield grid, None
        for _ in self.channels[1:]:
            out_coords, out_valid, ogs = sc.downsample_coords(
                grid, 3, 2, 1, self.max_voxels)
            s_table = sc.neighbor_table(grid, out_coords, out_valid,
                                        sc.strided_conv_offsets(3, 1),
                                        stride=2)
            grid = sc.build_grid(out_coords, out_valid, ogs)
            yield grid, s_table

    def forward(self, feats: torch.Tensor, coords: torch.Tensor,
                valid: torch.Tensor, grid_shape) -> torch.Tensor:
        dt = self.dtype
        offs = sc.kernel_offsets(3)
        x = feats.to(dt)
        levels = []
        for i, (grid, s_table) in enumerate(
                self.lattices(coords, valid, grid_shape)):
            if s_table is not None:
                x = sc.sparse_conv_apply(x, s_table, getattr(self, f"down{i}"),
                                         grid.valid)
                x = torch.relu(layer_norm_one_pass(
                    getattr(self, f"down{i}_norm"), x)).to(dt)
            ctx = GatherCtx(sc.neighbor_table(grid, grid.coords, grid.valid,
                                              offs), grid.valid)
            x = getattr(self, f"enc{i}_conv")(x, ctx)
            x = getattr(self, f"enc{i}_block")(x, ctx)
            levels.append((x, grid, ctx))
        x, grid, _ = levels[-1]
        for i in range(len(self.channels) - 2, -1, -1):
            fx, fgrid, fctx = levels[i]
            idx = sc.lookup(grid, (fgrid.coords + 1) // 2, fgrid.valid)
            up = gather_rows(x, idx, idx >= 0)
            x = getattr(self, f"dec{i}_conv")(torch.cat([fx, up], -1), fctx)
            grid = fgrid
        return x

    @torch.no_grad()
    def voxel_occupancy(self, coords: torch.Tensor, valid: torch.Tensor,
                        grid_shape) -> list[dict]:
        """Occupied voxels of each downsampled level's lattice before the
        budget cuts it, beside the budget (host ints; synchronises)."""
        rows, prev = [], None
        for i, (grid, _) in enumerate(self.lattices(coords, valid,
                                                    grid_shape)):
            if prev is not None:
                rows.append({"level": i, "occupied": sc.count_downsampled(
                    prev, 3, 2, 1), "budget": self.max_voxels})
            prev = grid
        return rows


class SegmentSIR(nn.Module):
    """SIR backbone over ragged clusters in segment form: per block, a
    rel-MLP gate of ``f_cluster / 10``, two VFE layers with the per-cluster
    max broadcast back between them; the cluster descriptor is both maxima
    of every block."""

    def __init__(self, feat_dim: int, num_blocks: int = 3,
                 feat_channels: Tuple[int, int] = (128, 128),
                 rel_mlp_hidden: Tuple[int, int] = (16, 32),
                 xyz_normalizer: Tuple[float, float, float] = (20.0, 20.0,
                                                               4.0),
                 act: str = "gelu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        self.dtype = dtype
        # the divisions by constants as jitted XLA runs them
        self.register_buffer("inv_xyz_normalizer", torch.from_numpy(
            _reciprocal(xyz_normalizer)), persistent=False)
        self.inv_rel_dist_scaler = float(_reciprocal(10.0))
        c1, c2 = feat_channels
        width = feat_dim
        for i in range(num_blocks):
            self.add_module(f"block_{i}_rel_mlp", Mlp(
                3, tuple(rel_mlp_hidden) + (3 + width,), act=act,
                dtype=dtype))
            self.add_module(f"block_{i}_vfe_0",
                            VfeLayer(3 + width, c1, act, dtype))
            self.add_module(f"block_{i}_vfe_1",
                            VfeLayer(2 * c1, c2, act, dtype))
            width = c2

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor,
                f_cluster: torch.Tensor, seg: torch.Tensor,
                valid: torch.Tensor, num_segments: int):
        """xyz [N, 3]; feats [N, F]; f_cluster [N, 3]; seg [N] cluster slot
        (read only where ``valid``). Returns (point feats [N, C2], cluster
        feats [num_segments, num_blocks * (C1 + C2)])."""
        dt = self.dtype
        xyz_n = (xyz * self.inv_xyz_normalizer).to(dt)
        f_rel = (f_cluster * self.inv_rel_dist_scaler).to(dt)
        seg_safe = torch.where(valid, seg, num_segments)

        def group_max(x):
            return segment_max(torch.where(valid[:, None], x, -1e30),
                               seg_safe, num_segments + 1)[:num_segments]

        h = feats.to(dt)
        clusters = []
        for i in range(self.num_blocks):
            xin = torch.cat([xyz_n, h], -1)
            x = xin * getattr(self, f"block_{i}_rel_mlp")(f_rel)
            x = getattr(self, f"block_{i}_vfe_0")(x)
            g1 = group_max(x)
            x = torch.cat([x, gather_rows(g1, seg, valid)], -1)
            x = getattr(self, f"block_{i}_vfe_1")(x)
            clusters.append(torch.cat([g1, group_max(x)], -1))
            h = x
        return h, torch.cat(clusters, -1)


class SparseClusterHead(nn.Module):
    """Shared MLP, then per task (class) separate score / centre / size /
    rotation MLPs. ReLU; LayerNorm epsilon ``HEAD_LN_EPS``."""

    BRANCHES = (("score", 1), ("center", 3), ("dim", 3), ("rot", 2))

    def __init__(self, in_dim: int, num_tasks: int = 3,
                 shared_mlp: Tuple[int, ...] = (1024, 1024),
                 hidden: int = 128, layers: int = 2, act: str = "relu",
                 dtype: torch.dtype = torch.float32,
                 ln_eps: float = HEAD_LN_EPS):
        super().__init__()
        self.num_tasks = num_tasks
        self.shared = Mlp(in_dim, shared_mlp, act=act, dtype=dtype,
                          ln_eps=ln_eps)
        hid = (hidden,) * layers
        for t in range(num_tasks):
            for name, n in self.BRANCHES:
                self.add_module(f"task{t}_{name}", Mlp(
                    shared_mlp[-1], hid + (n,), is_head=True, act=act,
                    dtype=dtype, ln_eps=ln_eps))

    def forward(self, feats: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits [C, T], regressions [C, T, 8]), float32."""
        x = self.shared(feats)
        cls, reg = [], []
        for t in range(self.num_tasks):
            out = [getattr(self, f"task{t}_{name}")(x)
                   for name, _ in self.BRANCHES]
            cls.append(out[0])
            reg.append(torch.cat(out[1:], -1))
        return torch.cat(cls, -1).float(), torch.stack(reg, -2).float()


class Grouping(NamedTuple):
    """``FSD.group``'s result."""
    fg_idx: torch.Tensor      # [ncls, Nf] point indices
    fg_label: torch.Tensor    # [ncls, Nf] global cluster slot or -1
    fg_centers: torch.Tensor  # [ncls, Nf, 3] vote-shifted points


class FSD(nn.Module):
    """``FSD(cfg, device, generator)``: points carry x, y, z and
    ``POINT_DIM - 3`` features. Built on the CPU, its weights drawn from
    ``generator`` as flax initialises them when one is given, then moved to
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, cfg: FSDConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = c = cfg
        ncls = c.num_classes
        self.dtype = dt = getattr(torch, c.compute_dtype)
        self.vfe = DynamicVFE(POINT_DIM, feat_channels=c.vfe_channels,
                              voxel_size=c.voxel_size, pc_range=c.pc_range,
                              dtype=dt)
        self.unet = SparseUNet(c.vfe_channels[-1], c.unet_channels,
                               c.max_voxels, dt)
        pf = c.vfe_channels[-1] + c.unet_channels[0]
        self.seg_head = Mlp(pf, tuple(c.seg_head_hidden) + (4 * ncls,),
                            is_head=True, act="relu", dtype=dt,
                            ln_eps=HEAD_LN_EPS)
        if c.use_clustering:
            self.sir = SegmentSIR(
                4 * ncls + pf, c.sir_blocks, c.sir_channels,
                c.rel_mlp_hidden, c.xyz_normalizer, dtype=dt)
            head_in = c.sir_blocks * sum(c.sir_channels)
        else:
            hid = tuple(c.virtual_proj_hidden)
            self.virtual_proj = Mlp(pf + 3 + ncls + POINT_DIM - 3, hid,
                                    act="gelu", dtype=dt)
            self.ori_proj = Mlp(pf, hid, act="gelu", dtype=dt)
            self.mixer1 = SubMConv(hid[-1], c.virtual_mixer_channels, dt)
            self.mixer2 = SubMConv(c.virtual_mixer_channels,
                                   c.virtual_mixer_channels, dt)
            head_in = c.virtual_mixer_channels
        self.head = SparseClusterHead(
            head_in, ncls, c.shared_mlp, c.head_hidden, c.head_layers,
            dtype=dt)
        if generator is not None:
            init_flax_like_(self, generator)
            for p in self.parameters():
                if p.dim() == 3:
                    he_normal_(p, generator)
        self.to(dev)

    def segment(self, points: torch.Tensor, mask: torch.Tensor):
        """Stage 1 -> (seg_logits [N, ncls], votes [N, ncls, 3], point
        validity [N], per-point features [N, pf])."""
        c = self.cfg
        ncls = c.num_classes
        vres = vx.voxelize(points, mask, c.voxel_size, c.pc_range,
                           c.max_voxels)
        vfeat, pfeat = self.vfe(points, vres, c.max_voxels)
        vout = self.unet(vfeat, vres.coords, vres.voxel_valid, c.grid_shape)
        p2v = vres.point2voxel
        per_point = torch.cat(
            [pfeat, gather_rows(vout, p2v, p2v >= 0).to(pfeat.dtype)], -1)
        out = self.seg_head(per_point).float()
        return (out[:, :ncls], out[:, ncls:].reshape(-1, ncls, 3),
                vres.point_valid, per_point)

    def _foreground(self, points, seg_logits, votes, point_valid, cls_id):
        """Class ``cls_id``'s top-scored points: (indices [Nf], over the
        threshold [Nf], vote-shifted centres [Nf, 3])."""
        c = self.cfg
        score = torch.where(point_valid, torch.sigmoid(seg_logits[:, cls_id]),
                            -1.0)
        top, fg_idx = _top_scores(score, c.max_fg_per_class)
        centers = points[fg_idx, :3] + votes[fg_idx, cls_id]
        return fg_idx, top > c.seg_score_thresh[cls_id], centers

    def group(self, points: torch.Tensor, seg_logits: torch.Tensor,
              votes: torch.Tensor, point_valid: torch.Tensor,
              counts: dict | None = None) -> Grouping:
        """Per-class foreground sampling and clustering (no gradient flows
        through it). ``counts``, where given, receives per class the
        budgets' counts as 0-d tensors: foreground points over the
        threshold, cluster voxels and clusters, each before its budget."""
        c = self.cfg
        kc = c.max_clusters_per_class
        vmax = c.max_cluster_voxels
        fg_idx_list, label_list, centers_list = [], [], []
        for cls_id in range(c.num_classes):
            fg_idx, fg_ok, centers = self._foreground(
                points, seg_logits, votes, point_valid, cls_id)
            vsize = c.cluster_voxel_size[cls_id]
            cres = vx.voxelize(centers, fg_ok, vsize, c.pc_range, vmax)
            p2v = cres.point2voxel
            n_pts = torch.bincount(torch.where(p2v >= 0, p2v, vmax),
                                   minlength=vmax + 1)[:vmax]
            vox_ok = cres.voxel_valid & (n_pts >= c.min_points)
            vmean = vx.scatter_to_voxels(centers, p2v, vmax, "mean")
            win = int(np.ceil(c.connected_dist[cls_id]
                              / min(vsize[0], vsize[1]))) + 1
            vox_labels = cl.connected_components_dist(
                cres.coords, vox_ok, _grid_shape(c.pc_range, vsize, True),
                vmean, c.connected_dist[cls_id], window_radius=min(win, 4))
            if counts is not None:
                name = c.class_names[cls_id]
                score = torch.sigmoid(seg_logits[:, cls_id])
                counts[name] = {
                    "fg_points": ((score > c.seg_score_thresh[cls_id])
                                  & point_valid).sum(),
                    "cluster_voxels": cres.num_voxels,
                    "clusters": cl.compact_labels(vox_labels, vmax)[1]}
            vox_labels, _ = cl.compact_labels(vox_labels, kc)
            pt_label = torch.where(p2v >= 0, vox_labels[p2v.clamp(min=0)], -1)
            pt_label = torch.where(fg_ok & (pt_label >= 0),
                                   pt_label + cls_id * kc, -1)
            fg_idx_list.append(fg_idx)
            label_list.append(pt_label)
            centers_list.append(centers)
        return Grouping(torch.stack(fg_idx_list), torch.stack(label_list),
                        torch.stack(centers_list))

    def _decode(self, out: dict, cluster_xyz: torch.Tensor) -> dict:
        """Every task's boxes against the cluster base points, and the
        cluster's own class's."""
        c = self.cfg
        n = c.max_clusters
        cluster_class = torch.arange(n, device=cluster_xyz.device) \
            // c.max_clusters_per_class
        boxes_tasks = coder.point_decode(out["reg_tasks"],
                                         cluster_xyz[:, None, :])
        own = boxes_tasks[torch.arange(n, device=cluster_xyz.device),
                          cluster_class]
        return dict(out, boxes_tasks=boxes_tasks, boxes=own,
                    cluster_centers=cluster_xyz, cluster_class=cluster_class)

    def cluster_forward(self, points: torch.Tensor, seg_logits, votes,
                        point_valid, pfeat, grouping: Grouping) -> dict:
        """The SIR and the head over ``grouping``'s clusters, and the
        decode: the forward's output dict."""
        c = self.cfg
        ncls = c.num_classes
        n = c.max_clusters
        flat_idx = grouping.fg_idx.reshape(-1).long()
        flat_label = grouping.fg_label.reshape(-1).long()
        flat_centers = grouping.fg_centers.reshape(-1, 3)
        valid = flat_label >= 0
        seg_ids = torch.where(valid, flat_label, n)

        # cluster base point: the mean of its points' vote centres
        csum = segment_sum(flat_centers, seg_ids, n + 1)
        cnt = torch.bincount(seg_ids, minlength=n + 1)
        cluster_xyz = (csum / cnt.clamp(min=1)[:, None].to(csum.dtype))[:n]
        cluster_valid = cnt[:n] > 0

        xyz = points[flat_idx, :3]
        feats = torch.cat(
            [seg_logits.index_select(0, flat_idx),
             votes.index_select(0, flat_idx).reshape(-1, ncls * 3),
             pfeat.index_select(0, flat_idx)], -1)
        f_cluster = xyz - gather_rows(cluster_xyz, flat_label, valid)
        _, cluster_feats = self.sir(xyz, feats, f_cluster, seg_ids, valid, n)
        cls_logits, reg_preds = self.head(cluster_feats)
        return self._decode(dict(
            seg_logits=seg_logits, votes=votes, point_valid=point_valid,
            cls=cls_logits, reg_tasks=reg_preds,
            cluster_valid=cluster_valid), cluster_xyz)

    def _virtual_voxels(self, points, seg_logits, votes, pv, pfeat):
        """FSDv2: the vote-shifted virtual points (projected features) and
        the original points (``ori_proj`` features) voxelized together,
        mixed by two submanifold convs; a voxel holding a class-c virtual
        point is a class-c instance, based at the voxel's centre. Returns
        (cluster feats [C, Dm], cluster_xyz [C, 3], cluster_valid [C])."""
        c = self.cfg
        ncls = c.num_classes
        kc = c.max_clusters_per_class
        n = c.max_clusters
        vmax = c.max_virtual_voxels
        dev = points.device
        xyz = points[:, :3]

        parts = [self._foreground(points, seg_logits, votes, pv, k)
                 for k in range(ncls)]
        v_idx = torch.cat([p[0] for p in parts])
        v_ok = torch.cat([p[1] for p in parts])
        v_ctr = torch.cat([p[2] for p in parts])
        v_cls = torch.arange(ncls, device=dev).repeat_interleave(
            c.max_fg_per_class)

        offset = (v_ctr - xyz[v_idx]) / 10.0
        vfeat = self.virtual_proj(torch.cat(
            [pfeat.index_select(0, v_idx), offset, seg_logits[v_idx],
             points[v_idx, 3:]], -1))
        ofeat = self.ori_proj(pfeat)

        union_pts = torch.cat([xyz, v_ctr], 0)
        union_feat = torch.cat([ofeat, vfeat], 0)
        union_ok = torch.cat([pv, v_ok], 0)
        union_cls = torch.cat([torch.full_like(pv, -1, dtype=torch.long),
                               v_cls], 0)

        vres = vx.voxelize(union_pts, union_ok, c.virtual_voxel_size,
                           c.pc_range, vmax)
        feat_v = vx.scatter_to_voxels(union_feat, vres.point2voxel, vmax,
                                      "mean")
        grid = sc.build_grid(vres.coords, vres.voxel_valid, _grid_shape(
            c.pc_range, c.virtual_voxel_size, True))
        ctx = GatherCtx(sc.neighbor_table(grid, vres.coords,
                                          vres.voxel_valid,
                                          sc.kernel_offsets(3)),
                        vres.voxel_valid)
        x = self.mixer2(self.mixer1(feat_v, ctx), ctx)

        # the classes of each voxel's virtual points
        seg = torch.where(vres.point2voxel >= 0, vres.point2voxel, vmax)
        onehot = ((union_cls[:, None] == torch.arange(ncls, device=dev))
                  & union_ok[:, None]).float()
        has_cls = (segment_sum(onehot, seg, vmax + 1)[:vmax] > 0) \
            & vres.voxel_valid[:, None]                      # [V, ncls]
        vs = torch.tensor(c.virtual_voxel_size, dtype=torch.float32,
                          device=dev)
        lo = torch.tensor(c.pc_range[:3], dtype=torch.float32, device=dev)
        centers = (vres.coords.float() + 0.5) * vs + lo

        # class k's voxels fill slots k * kc + rank; the rest drop into a
        # spare row sliced off
        cluster_feats = x.new_zeros((n + 1, x.shape[-1]))
        cluster_xyz = centers.new_zeros((n + 1, 3))
        cluster_valid = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        for k in range(ncls):
            flag = has_cls[:, k]
            rank = torch.cumsum(flag, 0) - 1
            slot = torch.where(flag & (rank < kc), k * kc + rank, n)
            cluster_feats = cluster_feats.index_put((slot,), x)
            cluster_xyz = cluster_xyz.index_put((slot,), centers)
            cluster_valid = cluster_valid.index_put((slot,), flag)
        return cluster_feats[:n], cluster_xyz[:n], cluster_valid[:n]

    def forward(self, points: torch.Tensor, mask: torch.Tensor,
                grouping: Grouping | None = None) -> dict:
        """points [N, POINT_DIM] float32, mask [N] bool -> dict of
        ``seg_logits`` [N, ncls], ``votes`` [N, ncls, 3], ``point_valid``,
        ``cls`` [C, T] task logits, ``reg_tasks`` [C, T, 8],
        ``boxes_tasks`` [C, T, 7], ``boxes`` [C, 7] (each cluster's own
        class), ``cluster_valid``, ``cluster_centers``, ``cluster_class``;
        C = ``max_clusters``. ``grouping`` (FSD only) replaces
        :meth:`group`'s, for a caller that holds one run against another
        from the same clusters."""
        seg_logits, votes, pv, pfeat = self.segment(points, mask)
        if not self.cfg.use_clustering:
            feats, cluster_xyz, cluster_valid = self._virtual_voxels(
                points, seg_logits.detach(), votes.detach(), pv, pfeat)
            cls_logits, reg_preds = self.head(feats)
            return self._decode(dict(
                seg_logits=seg_logits, votes=votes, point_valid=pv,
                cls=cls_logits, reg_tasks=reg_preds,
                cluster_valid=cluster_valid), cluster_xyz)
        if grouping is None:
            grouping = self.group(points, seg_logits.detach(),
                                  votes.detach(), pv)
        return self.cluster_forward(points, seg_logits, votes, pv, pfeat,
                                    grouping)

    def loss(self, points, mask, gt_boxes, gt_labels, gt_valid) -> dict:
        return fsd_loss(self(points, mask), points, gt_boxes, gt_labels,
                        gt_valid, self.cfg)

    @torch.no_grad()
    def budget_counts(self, points: torch.Tensor, mask: torch.Tensor
                      ) -> dict:
        """What each budget holds before it cuts, beside the budget (host
        ints; synchronises): the UNet's voxels per level, and per class the
        foreground points over the threshold, the cluster voxels and the
        clusters (FSD; FSDv2: the virtual voxels)."""
        c = self.cfg
        vres = vx.voxelize(points, mask, c.voxel_size, c.pc_range,
                           c.max_voxels)
        rows = {"unet": [{"level": 0, "occupied": int(vres.num_voxels),
                          "budget": c.max_voxels}]
                + self.unet.voxel_occupancy(vres.coords, vres.voxel_valid,
                                            c.grid_shape)}
        seg_logits, votes, pv, _ = self.segment(points, mask)
        counts = {}
        if c.use_clustering:
            self.group(points, seg_logits, votes, pv, counts)
            for name, cnt in counts.items():
                rows[name] = {
                    "fg_points": [int(cnt["fg_points"]), c.max_fg_per_class],
                    "cluster_voxels": [int(cnt["cluster_voxels"]),
                                       c.max_cluster_voxels],
                    "clusters": [int(cnt["clusters"]),
                                 c.max_clusters_per_class]}
        else:
            parts = [self._foreground(points, seg_logits, votes, pv, k)
                     for k in range(c.num_classes)]
            union = torch.cat([points[:, :3]] + [p[2] for p in parts], 0)
            ok = torch.cat([pv] + [p[1] for p in parts], 0)
            nv = vx.voxelize(union, ok, c.virtual_voxel_size, c.pc_range,
                             c.max_virtual_voxels).num_voxels
            rows["virtual_voxels"] = [int(nv), c.max_virtual_voxels]
            for k, name in enumerate(c.class_names):
                score = torch.sigmoid(seg_logits[:, k])
                rows[name] = {"fg_points": [int(
                    ((score > c.seg_score_thresh[k]) & pv).sum()),
                    c.max_fg_per_class]}
        return rows


def focal_bce(logits, targets, alpha, gamma):
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a boolean [G, N] over G: the first True row, 0
    where there is none."""
    return mask.to(torch.uint8).argmax(0)


def fsd_loss(model_out: dict, points, gt_boxes, gt_labels, gt_valid,
             cfg: FSDConfig | None = None) -> dict:
    """The reference's losses:

    * segmentation: per-class sigmoid focal loss, each point's class target
      from the first GT box that holds it;
    * votes: L1 to that box's gravity centre, on the point's own class
      channel;
    * per task t: focal classification of every valid cluster (positive
      where its base point lies in a class-t GT box) and L1 on the 8-d
      point-coder target of the positives, centre / size / rotation
      weighted 0.5 / 0.5 / 0.2."""
    cfg = cfg or FSDConfig()
    f32 = torch.float32
    dev = points.device
    pv = model_out["point_valid"]
    xyz = points[:, :3]
    labels = gt_labels.long()
    inbox = box_ops.points_in_boxes(xyz, gt_boxes) & gt_valid[:, None]
    fg = inbox.any(0)
    gt_of_point = _first_true(inbox)
    point_cls = labels[gt_of_point]                          # [N]

    seg_logits = model_out["seg_logits"]                     # [N, ncls]
    ncls = seg_logits.shape[-1]
    classes = torch.arange(ncls, device=dev)
    seg_tgt = (point_cls[:, None] == classes).to(f32) * fg[:, None].to(f32)
    seg_ce = focal_bce(seg_logits, seg_tgt, cfg.seg_focal_alpha,
                       cfg.seg_focal_gamma)
    pvf = pv.to(f32)
    loss_seg = cfg.seg_weight * (seg_ce * pvf[:, None]).sum() \
        / pvf.sum().clamp(min=1)

    vote_tgt = box_ops.gravity_center(gt_boxes)[gt_of_point] - xyz
    own_vote = model_out["votes"][torch.arange(xyz.shape[0], device=dev),
                                  point_cls]
    vw = (fg & pv).to(f32)
    loss_vote = cfg.vote_weight * ((own_vote - vote_tgt).abs()
                                   * vw[:, None]).sum() / vw.sum().clamp(min=1)

    cc = model_out["cluster_centers"]
    cvalid = model_out["cluster_valid"]
    cin = box_ops.points_in_boxes(cc, gt_boxes) & gt_valid[:, None]  # [G, C]
    code_w = torch.tensor([cfg.center_weight] * 3 + [cfg.size_weight] * 3
                          + [cfg.rot_weight] * 2, dtype=f32, device=dev)
    cw = cvalid.to(f32)
    cls_avg = cw.sum().clamp(min=1)
    loss_cls = loss_center = loss_size = loss_rot = 0.0
    num_pos_total = 0.0
    for t in range(ncls):
        cin_t = cin & ((labels == t) & gt_valid)[:, None]
        pos = cin_t.any(0) & cvalid                          # [C]
        gt_t = gt_boxes[_first_true(cin_t)]
        loss_cls = loss_cls + cfg.cls_weight * (focal_bce(
            model_out["cls"][:, t], pos.to(f32), cfg.cls_focal_alpha,
            cfg.cls_focal_gamma) * cw).sum() / cls_avg
        err = (model_out["reg_tasks"][:, t] - coder.point_encode(gt_t, cc)
               ).abs() * code_w
        posf = pos.to(f32)[:, None]
        num_pos = pos.to(f32).sum()
        reg_avg = num_pos.clamp(min=1)
        loss_center = loss_center + (err[:, :3] * posf).sum() / reg_avg
        loss_size = loss_size + (err[:, 3:6] * posf).sum() / reg_avg
        loss_rot = loss_rot + (err[:, 6:8] * posf).sum() / reg_avg
        num_pos_total = num_pos_total + num_pos
    total = (loss_seg + loss_vote + loss_cls + loss_center + loss_size
             + loss_rot)
    return dict(loss_seg=loss_seg, loss_vote=loss_vote, loss_cls=loss_cls,
                loss_center=loss_center, loss_size=loss_size,
                loss_rot=loss_rot, loss=total,
                num_fg_points=(fg & pv).sum(),
                num_pos_clusters=num_pos_total)
