"""3D box geometry (counterpart of the JAX package's ``core/boxes.py``,
the parts the OcOccNet forward and losses and FSD use).

Boxes are ``[..., 7]``: bottom centre (x, y, z), sizes (w, l, h) along
(x, y, z), yaw about z. The box-local frame is
``rotate_z(p - gravity_center, -yaw)``, so ``local_x`` spans ``w`` and a
point is inside iff ``|local| <= size / 2`` componentwise.
"""
from __future__ import annotations

import torch


def rotate_z(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate ``points[..., 3]`` by ``angles[...]`` about z:
    out_x = x cos + y sin, out_y = -x sin + y cos."""
    c = torch.cos(angles)[..., None]
    s = torch.sin(angles)[..., None]
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    ox = x * c + y * s
    oy = -x * s + y * c
    return torch.cat([ox, oy, z.expand(ox.shape)], -1)


def gravity_center(boxes: torch.Tensor) -> torch.Tensor:
    """Bottom-centre boxes -> volumetric centres, ``[..., 3]``."""
    z = boxes[..., 2:3] + 0.5 * boxes[..., 5:6]
    return torch.cat([boxes[..., 0:2], z], -1)


def box_local_coords(points: torch.Tensor, boxes: torch.Tensor
                     ) -> torch.Tensor:
    """``points[..., P, 3]`` in the local frame of ``boxes[..., 7]``."""
    ctr = gravity_center(boxes)
    return rotate_z(points - ctr[..., None, :], -boxes[..., None, 6])


def local_to_global(local: torch.Tensor, boxes: torch.Tensor
                    ) -> torch.Tensor:
    """Inverse of :func:`box_local_coords`."""
    ctr = gravity_center(boxes)
    return rotate_z(local, boxes[..., None, 6]) + ctr[..., None, :]


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor,
                    extra_wlh=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Boolean ``[..., P]``: whether each of ``points[..., P, 3]`` lies in
    ``boxes[..., 7]`` (broadcast against the points' leading dims), each
    size enlarged by ``extra_wlh`` in total."""
    local = box_local_coords(points, boxes)
    extra = torch.as_tensor(extra_wlh, dtype=points.dtype,
                            device=points.device)
    half = 0.5 * (boxes[..., None, 3:6] + extra)
    return (local.abs() <= half).all(-1)


def rotate_z_2d(xy: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """2D :func:`rotate_z` for BEV work."""
    c = torch.cos(angles)[..., None]
    s = torch.sin(angles)[..., None]
    x, y = xy[..., 0:1], xy[..., 1:2]
    return torch.cat([x * c + y * s, -x * s + y * c], -1)


def corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """The 8 corners ``[..., 8, 3]`` of bottom-centre boxes: the bottom
    face, then the top face, each in the order of :func:`corners_bev`."""
    w, l, h = boxes[..., 3:4], boxes[..., 4:5], boxes[..., 5:6]
    sx = torch.stack([w, -w, -w, w] * 2, -2) * 0.5          # [..., 8, 1]
    sy = torch.stack([l, l, -l, -l] * 2, -2) * 0.5
    sz = torch.cat([torch.zeros_like(sx[..., :4, :]),
                    h[..., None, :].expand(sx[..., :4, :].shape)], -2)
    bev = (rotate_z_2d(torch.cat([sx, sy], -1), boxes[..., None, 6])
           + boxes[..., None, 0:2])
    return torch.cat([bev, sz + boxes[..., None, 2:3]], -1)


def corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """BEV corners ``[..., 4, 2]``, counter-clockwise in the box frame."""
    w, l = boxes[..., 3:4], boxes[..., 4:5]
    sx = torch.stack([w, -w, -w, w], -2) * 0.5              # [..., 4, 1]
    sy = torch.stack([l, l, -l, -l], -2) * 0.5
    return (rotate_z_2d(torch.cat([sx, sy], -1), boxes[..., None, 6])
            + boxes[..., None, 0:2])


# vertex slots of a clipped polygon: a 4-gon clipped by 4 half-planes has at
# most 8 vertices
_MAX_V = 8


def _next_vertex(nvalid: torch.Tensor) -> torch.Tensor:
    """``[..., 8]``: the slot of the vertex after each slot, wrapping at
    ``nvalid``."""
    idx = torch.arange(1, _MAX_V + 1, device=nvalid.device)
    return torch.where(idx >= nvalid[..., None], 0, idx)


def _polygon_area(verts: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """Shoelace area of convex polygons in fixed ``[..., 8, 2]`` buffers,
    the first ``nvalid`` slots valid."""
    j = _next_vertex(nvalid)
    x, y = verts[..., 0], verts[..., 1]
    cross = x * torch.gather(y, -1, j) - torch.gather(x, -1, j) * y
    valid = torch.arange(_MAX_V, device=nvalid.device) < nvalid[..., None]
    return 0.5 * torch.where(valid, cross, 0.0).sum(-1).abs()


def rotated_bev_overlap(boxes1: torch.Tensor, boxes2: torch.Tensor
                        ) -> torch.Tensor:
    """Paired rotated-rectangle intersection area in BEV, ``[...]``:
    Sutherland-Hodgman clipping of box 1's 4-gon by box 2's 4 half-planes
    in a fixed 8-vertex buffer, with static shapes and no read-back to the
    host. Each clip step emits, per input edge, the vertex (if inside) and
    the crossing (if the edge crosses), then moves the emitted slots to the
    front with a stable sort."""
    boxes1, boxes2 = torch.broadcast_tensors(boxes1, boxes2)
    subj, clip = corners_bev(boxes1), corners_bev(boxes2)   # [..., 4, 2]
    lead = subj.shape[:-2]
    verts = torch.cat([subj, subj.new_zeros(lead + (_MAX_V - 4, 2))], -2)
    nvalid = torch.full(lead, 4, dtype=torch.int64, device=subj.device)
    idx = torch.arange(_MAX_V, device=subj.device)
    for k in range(4):
        a, b = clip[..., k, :], clip[..., (k + 1) % 4, :]
        ab = b - a
        rel = verts - a[..., None, :]
        # inside: left of the edge a -> b of the counter-clockwise clip
        side = ab[..., None, 0] * rel[..., 1] - ab[..., None, 1] * rel[..., 0]
        valid = idx < nvalid[..., None]
        inside = (side >= 0) & valid
        j = _next_vertex(nvalid)
        vnext = torch.gather(verts, -2, j[..., None].expand(verts.shape))
        side_next = torch.gather(side, -1, j)
        inside_next = torch.gather(inside, -1, j)
        denom = side - side_next
        t = side / torch.where(denom.abs() < 1e-12, 1e-12, denom)
        inter = verts + t[..., None] * (vnext - verts)
        # per input edge: the vertex, then the crossing
        out_pts = torch.stack([verts, inter], -2).reshape(
            lead + (2 * _MAX_V, 2))
        out_msk = torch.stack([inside & valid,
                               (inside != inside_next) & valid],
                              -1).reshape(lead + (2 * _MAX_V,))
        order = torch.sort((~out_msk).to(torch.int32), dim=-1,
                           stable=True).indices[..., :_MAX_V]
        verts = torch.gather(out_pts, -2, order[..., None].expand(
            lead + (_MAX_V, 2)))
        nvalid = out_msk.sum(-1).clamp(max=_MAX_V)
    area = _polygon_area(verts, nvalid)
    return torch.where(nvalid >= 3, area, 0.0)


def aligned_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor
                   ) -> torch.Tensor:
    """Paired (1-to-1) 3D IoU: rotated BEV overlap times height overlap,
    over the union (clamped below at 1e-8)."""
    top1 = boxes1[..., 2] + boxes1[..., 5]
    top2 = boxes2[..., 2] + boxes2[..., 5]
    overlap_h = (torch.minimum(top1, top2)
                 - torch.maximum(boxes1[..., 2], boxes2[..., 2])).clamp(min=0)
    inter = rotated_bev_overlap(boxes1, boxes2) * overlap_h
    vol1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    vol2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    return inter / (vol1 + vol2 - inter).clamp(min=1e-8)


def pairwise_iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> torch.Tensor:
    """Full ``[N, M]`` rotated BEV IoU matrix."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    inter = rotated_bev_overlap(boxes1[:, None].expand(n, m, 7),
                                boxes2[None].expand(n, m, 7))
    a1 = (boxes1[:, 3] * boxes1[:, 4])[:, None]
    a2 = (boxes2[:, 3] * boxes2[:, 4])[None, :]
    return inter / (a1 + a2 - inter).clamp(min=1e-8)


def pairwise_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor
                    ) -> torch.Tensor:
    """Full ``[N, M]`` rotated 3D IoU matrix."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    return aligned_iou_3d(boxes1[:, None].expand(n, m, 7),
                          boxes2[None].expand(n, m, 7))


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
            max_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy rotated-BEV NMS with a fixed output size: ``(keep [max_out],
    valid [max_out])``, the kept boxes' input indices in descending score
    order, -1 past the last kept one. One IoU matrix, then a masked greedy
    sweep on the device (no read-back to the host)."""
    n = boxes.shape[0]
    if n == 0:
        return (torch.full((max_out,), -1, dtype=torch.int64,
                           device=boxes.device),
                torch.zeros(max_out, dtype=torch.bool, device=boxes.device))
    order = torch.argsort(-scores, stable=True)
    suppress = pairwise_iou_bev(boxes[order], boxes[order]) > iou_thresh
    later = (torch.arange(n, device=boxes.device)[None, :]
             > torch.arange(n, device=boxes.device)[:, None])
    suppress &= later
    alive = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        # a box still alive kills every lower-scored box it overlaps
        alive &= ~(suppress[i] & alive[i])
    rank = torch.cumsum(alive, 0) - 1
    slot = torch.where(alive, rank, max_out)
    out = torch.full((max_out + 1,), -1, dtype=torch.int64,
                     device=boxes.device)
    out.scatter_(0, slot.clamp(max=max_out),
                 torch.arange(n, device=boxes.device))
    out = out[:max_out]
    valid = out >= 0
    return torch.where(valid, order[out.clamp(0, n - 1)], -1), valid
