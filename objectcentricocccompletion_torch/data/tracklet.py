"""The tracklet batch OcOccNet reads (counterpart of the JAX package's
``models/ococcnet.py::TrackletBatch``); the data generators and the model
both import it from here."""
from __future__ import annotations

from typing import NamedTuple

import torch


class TrackletBatch(NamedTuple):
    """One batch of regularised tracklets (all tensors static-shape)."""
    points: torch.Tensor        # [B, L, P, 3+F] shared-frame xyz + feats
    points_mask: torch.Tensor   # [B, L, P] bool
    rois: torch.Tensor          # [B, L, 7] per-frame proposal boxes
    roi_scores: torch.Tensor    # [B, L] detector scores
    frame_inds: torch.Tensor    # [B, L] int32 temporal indices
    gt_boxes: torch.Tensor      # [B, L, 7] per-frame GT box
    gt_valid: torch.Tensor      # [B, L] bool
    occ_points: torch.Tensor    # [B, K, 3] GT-box-frame occupancy samples
    occ_labels: torch.Tensor    # [B, K] int32 {1 occupied, 0 free}
    occ_mask: torch.Tensor      # [B, K] bool
    occ_score: torch.Tensor     # [B] annotation confidence

    def to(self, device) -> "TrackletBatch":
        return TrackletBatch(*(x.to(device) for x in self))
