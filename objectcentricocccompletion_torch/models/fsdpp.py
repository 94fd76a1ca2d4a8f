"""FSD++, incremental multi-frame fully sparse detection (counterpart of the
JAX package's ``models/fsdpp.py``).

The frames of a sequence run in order. Each step keeps the current frame's
*novel* points (those in voxels that no memory point occupies,
``ops/incremental.py``) and the memory points inside the previous
detections' seed boxes (``ops/seeds.py``), and runs the wrapped detector on
the merged cloud ``[points; memory]``: two-stage FSD by default, single-stage
FSD with ``two_stage=False``. The novel points then enter the memory, a
fixed-size point buffer with a per-point age (``max_age > 0`` evicts the
older ones), and the step's detections become the next step's seeds.

The state a step returns is detached: no gradient crosses frames (the crop
and the memory update are boolean selections, and the JAX trainer stops
the gradient on the carried state).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from ..ops import seeds as seed_ops
from ..ops.incremental import incremental_points_mask
from ..ops.seeds import Seeds, empty_seeds
from ..utils.device import resolve_device
from .fsd import FSD, FSDConfig, Grouping, tiny_fsd_config
from .fsd_two_stage import TwoStageFSD, TwoStageFSDConfig


@dataclasses.dataclass(frozen=True)
class FSDPPConfig:
    fsd: FSDConfig = dataclasses.field(default_factory=FSDConfig)
    memory_size: int = 320000
    inc_voxel_size: tuple = (0.4, 0.4, 0.4)
    # the group-correction second stage (TwoStageFSDPP); False: FSD
    two_stage: bool = True
    roi_points: int = 256
    # the memory enters each step only through the previous detections'
    # seed boxes; False: the whole memory does
    use_seeds: bool = True
    max_seeds: int = 128                   # seed capacity per frame
    seed_score_thr: float = 0.1
    max_crop_points: int = 256             # per seed box
    crop_extra_wlh: tuple = (1.0, 1.0, 1.0)
    ground_band: float | None = None       # remove_ground's |z| band
    # 0: no eviction by age; k > 0 evicts points older than k steps
    max_age: int = 0
    # training seed augmentation
    seed_fp_rate: float = 0.1
    seed_drop_rate: float = 0.1


def tiny_fsdpp_config(two_stage: bool = True,
                      use_seeds: bool = True) -> FSDPPConfig:
    return FSDPPConfig(fsd=tiny_fsd_config(), memory_size=8192,
                       inc_voxel_size=(0.8, 0.8, 0.8), two_stage=two_stage,
                       roi_points=64, use_seeds=use_seeds, max_seeds=16,
                       max_crop_points=64, max_age=4)


class SequenceState(NamedTuple):
    memory: torch.Tensor        # [M, 3+F] past points
    memory_mask: torch.Tensor   # [M] bool
    memory_age: torch.Tensor    # [M] int32 steps since insertion
    seeds: Seeds                # the previous step's detections

    def to(self, device) -> "SequenceState":
        return SequenceState(self.memory.to(device),
                             self.memory_mask.to(device),
                             self.memory_age.to(device),
                             self.seeds.to(device))


def init_sequence_state(cfg: FSDPPConfig, feat_dim: int, device="cpu"
                        ) -> SequenceState:
    """An empty memory and no valid seeds."""
    m = cfg.memory_size
    return SequenceState(torch.zeros((m, feat_dim), device=device),
                         torch.zeros((m,), dtype=torch.bool, device=device),
                         torch.zeros((m,), dtype=torch.int32, device=device),
                         empty_seeds(cfg.max_seeds, device))


def _stable_false_first(flags: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(flags)`` of a boolean (stable): the indices of the
    False entries in order, then the True ones. Sorted as uint8."""
    return torch.argsort(flags.to(torch.uint8), stable=True)


class FSDPP(nn.Module):
    """``FSDPP(cfg, device, generator)``: the wrapped detector ``fsd``
    (``TwoStageFSD``, or ``FSD`` with ``two_stage=False``) built and
    initialised as it is."""

    def __init__(self, cfg: FSDPPConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if cfg.two_stage:
            self.fsd = TwoStageFSD(TwoStageFSDConfig(
                fsd=cfg.fsd, roi_points=cfg.roi_points), dev, generator)
        else:
            self.fsd = FSD(cfg.fsd, dev, generator)

    def init_state(self, feat_dim: int) -> SequenceState:
        return init_sequence_state(self.cfg, feat_dim,
                                   next(self.parameters()).device)

    def inputs(self, state: SequenceState, points: torch.Tensor,
               mask: torch.Tensor, seeds: Seeds | None = None):
        """The step's selection: (novel [N], merged cloud [N + M, C],
        merged mask [N + M]). No gradient flows through it."""
        c = self.cfg
        novel = incremental_points_mask(
            state.memory, state.memory_mask, points, mask,
            c.inc_voxel_size, c.fsd.pc_range)
        if c.use_seeds:
            # the memory enters through its seed crops and the frame
            # through its novel points; with no valid seed (a sequence's
            # start) the first frame is all novel points
            mem_keep = seed_ops.crop_points_by_seeds(
                state.memory, state.memory_mask,
                seeds if seeds is not None else state.seeds,
                c.max_crop_points, c.crop_extra_wlh, c.ground_band)
            cur_keep = mask & novel
        else:
            mem_keep = state.memory_mask
            cur_keep = mask
        merged = torch.cat([points, state.memory], 0)
        return novel, merged, torch.cat([cur_keep, mem_keep], 0)

    def forward(self, state: SequenceState, points: torch.Tensor,
                mask: torch.Tensor, seeds: Seeds | None = None,
                grouping: Grouping | None = None,
                selection: tuple | None = None, record: list | None = None):
        """One sequence step -> (new state, the detector's output dict with
        ``input_mask``, the merged cloud's mask). ``seeds`` replaces the
        carried seeds (training feeds augmented ones). ``grouping`` and
        ``selection`` go to the wrapped detector (``selection`` to
        two-stage FSD only), for a caller that holds one run against
        another from the same clusters and pooled points; ``record``, where
        no grouping is given, receives the ``(grouping, selection)`` that
        :meth:`detector_selection` computes and the step then uses."""
        c = self.cfg
        novel, merged, merged_mask = self.inputs(state, points, mask, seeds)
        if record is not None and grouping is None:
            grouping, selection = self.detector_selection(merged, merged_mask)
            record.append((grouping, selection))
        if c.two_stage:
            out = self.fsd(merged, merged_mask, grouping, selection)
        else:
            out = self.fsd(merged, merged_mask, grouping)
        out = dict(out, input_mask=merged_mask)
        return self.next_state(state, points, novel, out), out

    @torch.no_grad()
    def detector_selection(self, points: torch.Tensor, mask: torch.Tensor
                           ) -> tuple:
        """The wrapped detector's own grouping on a cloud and, for two-stage
        FSD, its pooled points: ``(grouping, selection or None)``."""
        two = self.cfg.two_stage
        stage1 = self.fsd.stage1 if two else self.fsd
        seg_logits, votes, pv, _ = stage1.segment(points, mask)
        grouping = stage1.group(points, seg_logits, votes, pv)
        if not two:
            return grouping, None
        out1 = stage1(points, mask, grouping)
        return grouping, self.fsd.select_points(points, mask, out1["boxes"])

    def next_state(self, state: SequenceState, points: torch.Tensor,
                   novel: torch.Tensor, out: dict) -> SequenceState:
        """The memory update (novel points enter at age 0, in front) and
        the seeds of this step's detections, detached."""
        c = self.cfg
        age = state.memory_age + 1
        mem_ok = state.memory_mask
        if c.max_age > 0:
            mem_ok = mem_ok & (age <= c.max_age)
        order = _stable_false_first(~novel)
        cat_pts = torch.cat([points[order], state.memory], 0)
        cat_ok = torch.cat([novel[order], mem_ok], 0)
        cat_age = torch.cat([torch.zeros_like(age[:1]).expand(
            novel.shape[0]), age], 0)
        keep = _stable_false_first(~cat_ok)[:c.memory_size]

        if c.two_stage:
            boxes = out["refined_boxes"]
            scores = torch.sigmoid(out["cls2"])
            valid = out["roi_nonempty"]
        else:
            boxes = out["boxes"]
            own = out["cls"].gather(1, out["cluster_class"][:, None])[:, 0]
            scores = torch.sigmoid(own)
            valid = out["cluster_valid"]
        new_seeds = seed_ops.seeds_from_output(
            boxes.detach(), out["cluster_class"], scores.detach(), valid,
            c.max_seeds, c.seed_score_thr)
        return SequenceState(cat_pts[keep].detach(), cat_ok[keep],
                             cat_age[keep], new_seeds)
