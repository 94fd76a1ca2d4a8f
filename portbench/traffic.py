"""Seeded traffic: tracklets and LiDAR frames drawn on a device from a
``torch.Generator``, by the parameters of a mix file (``traffic/*.json``).

The laws are those of the port's synthetic data (``data/synthetic.py``),
extended to tracklets of any length:

- a tracklet is a box moving along a near-linear trajectory from a start
  at a stratified range, with points on
  its surface, proposals near the GT boxes and occupancy queries in the
  proposal's box; a frame's valid point count falls with the inverse square
  of its range (every slot inside ``full_range_m``, at least ``min_points``);
- a frame is the returns of a spinning LiDAR over flat ground, walls and
  objects (``make_frames``): their density falls with range as the
  beams' rings spread.

Tracklets pad to their length bucket as the evaluator pads them
(``pad_tracklet``, a frozen copy of ``evalx/evaluator.py::pad_to_bucket``):
the last frame repeated with its points masked out, the frame indices
counting on.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator per (seed, stream) on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


class Tracklets(NamedTuple):
    """Tracklets laid end to end: ``start[i]`` and ``length[i]`` index the
    frame axis of every per-frame tensor."""
    start: list
    length: list
    points: torch.Tensor      # [F, P, 10]
    points_mask: torch.Tensor  # [F, P] bool
    rois: torch.Tensor        # [F, 7]
    roi_scores: torch.Tensor  # [F]
    gt_boxes: torch.Tensor    # [F, 7]
    gt_valid: torch.Tensor    # [F] bool
    queries: torch.Tensor     # [F, K, 3] box-local occupancy queries
    occ_points: torch.Tensor  # [n, K, 3] GT-box-frame occupancy samples
    occ_labels: torch.Tensor  # [n, K] int32
    occ_score: torch.Tensor   # [n]


def strata(n: int, g: torch.Generator) -> torch.Tensor:
    """The ``n`` midpoints of equal strata of [0, 1), in a seeded order:
    every seed draws the same set of values, so the same work."""
    return ((torch.arange(n, dtype=torch.float64) + 0.5) / n)[
        torch.randperm(n, generator=g)]


def tracklet_lengths(mix: dict, g: torch.Generator) -> list:
    """``mix["tracklets"]`` lengths at the quantiles of a log-uniform law
    over ``[min_len, max_len]``, in a seeded order (or all ``length`` where
    the mix fixes one)."""
    n = mix["tracklets"]
    if "length" in mix:
        return [int(mix["length"])] * n
    lo, hi = math.log(mix["min_len"]), math.log(mix["max_len"] + 1)
    return [min(int(math.exp(lo + (hi - lo) * x)), mix["max_len"])
            for x in strata(n, g).tolist()]


def make_tracklets(mix: dict, P: int, K: int, seed: int, device
                   ) -> Tracklets:
    """The mix's tracklets, ``P`` point slots per frame and ``K``
    occupancy queries per frame, drawn on ``device``."""
    lengths = tracklet_lengths(mix, generator(seed, 1, "cpu"))
    g = generator(seed, 2, device)
    n, F = len(lengths), sum(lengths)
    dev = device
    start = [0]
    for L in lengths[:-1]:
        start.append(start[-1] + L)
    tid = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.tensor(lengths, device=dev))
    t = (torch.arange(F, device=dev)
         - torch.tensor(start, device=dev)[tid]).float()

    # trajectory: near-linear motion with noise, from a start at a
    # stratified range (uniform over the disc of radius start_range_m) in
    # a seeded direction
    r = mix["start_range_m"] * strata(n, generator(seed, 5, "cpu")).sqrt()
    ang = _uniform(g, (n,), -math.pi, math.pi, dev)
    start_xy = torch.stack([torch.cos(ang), torch.sin(ang)], -1) * r.to(
        dev, torch.float32)[:, None]
    vel = _uniform(g, (n, 2), -mix["max_speed"], mix["max_speed"], dev)
    ctr_xy = (start_xy[tid] + vel[tid] * t[:, None]
              + 0.05 * torch.randn((F, 2), generator=g, device=dev))
    ctr_z = _uniform(g, (n, 1), -1.5, 0.5, dev)[tid]
    size = (torch.tensor([4.5, 2.0, 1.7], device=dev)
            + 0.4 * torch.randn((n, 3), generator=g, device=dev)).abs()
    size = size.clamp(min=0.5)[tid]
    yaw = (torch.atan2(vel[:, 1], vel[:, 0])[tid]
           + 0.05 * torch.randn(F, generator=g, device=dev))[:, None]
    gt = torch.cat([ctr_xy, ctr_z, size, yaw], -1)

    # proposals: GT + noise
    rois = gt + torch.cat([_uniform(g, (F, 3), -0.15, 0.15, dev),
                           _uniform(g, (F, 3), -0.1, 0.1, dev),
                           _uniform(g, (F, 1), -0.1, 0.1, dev)], -1)

    # points: on-surface samples in the box frame, pushed to ego
    u = _uniform(g, (F, P, 3), -0.5, 0.5, dev)
    face = torch.randint(0, 3, (F, P), generator=g, device=dev)
    sgn = torch.where(torch.rand((F, P), generator=g, device=dev) < 0.5,
                      -0.5, 0.5)
    u = torch.where(face[..., None] == torch.arange(3, device=dev),
                    sgn[..., None], u)
    local = u * size[:, None, :]
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    ex = local[..., 0:1] * c - local[..., 1:2] * s
    ey = local[..., 0:1] * s + local[..., 1:2] * c
    xyz = torch.cat([ex + ctr_xy[:, None, 0:1], ey + ctr_xy[:, None, 1:2],
                     local[..., 2:3] + ctr_z[:, None] + size[:, None, 2:3]
                     / 2], -1)
    feats = torch.cat([
        torch.rand((F, P, 2), generator=g, device=dev),
        (yaw / math.pi)[:, None, :].expand(F, P, 1),
        (size / 10.0)[:, None, :].expand(F, P, 3),
        torch.rand((F, 1, 1), generator=g, device=dev).expand(F, P, 1),
    ], -1)
    points = torch.cat([xyz, feats], -1)
    # LiDAR returns fall with the inverse square of the range
    dist = torch.linalg.vector_norm(ctr_xy, dim=-1)
    frac = ((mix["full_range_m"] / dist.clamp(min=1.0)) ** 2).clamp(0, 1)
    npts = (P * frac).long().clamp(min(mix["min_points"], P), P)
    mask = torch.arange(P, device=dev)[None] < npts[:, None]

    roi_scores = torch.rand(F, generator=g, device=dev) * 0.5 + 0.5
    gt_valid = torch.rand(F, generator=g, device=dev) < 0.95
    queries = _uniform(g, (F, K, 3), -0.5, 0.5, dev) * rois[:, None, 3:6]
    occ_points = _uniform(g, (n, K, 3), -0.5, 0.5, dev) * size[
        torch.tensor(start, device=dev)][:, None]
    occ_labels = (torch.rand((n, K), generator=g, device=dev)
                  < 0.4).to(torch.int32)
    occ_score = _uniform(g, (n,), 0.5, 1.0, dev)
    return Tracklets(start, lengths, points, mask, rois, roi_scores, gt,
                     gt_valid, queries, occ_points, occ_labels, occ_score)


def bucket_of(T: int, buckets) -> int:
    """The evaluator's length bucket of a ``T``-frame tracklet: the first
    that holds it, else ``T`` rounded up to a multiple of 64."""
    return next((b for b in buckets if b >= T), ((T + 63) // 64) * 64)


class Call(NamedTuple):
    """One refinement call: tracklet ids (repeats fill the last call of a
    bucket), the padded length, and how many frames are real."""
    ids: list
    L: int
    real_frames: int
    real_tracklets: int


def plan_calls(lengths: list, buckets, frames_per_call: int,
               g: torch.Generator) -> list:
    """Group tracklets by bucket into calls of ``frames_per_call`` padded
    frames; a bucket's last call repeats its last tracklet, and the repeats
    count as no real frame. The calls come in a seeded order."""
    by_bucket: dict = {}
    for i, T in enumerate(lengths):
        by_bucket.setdefault(bucket_of(T, buckets), []).append(i)
    calls = []
    for L in sorted(by_bucket):
        ids = by_bucket[L]
        per = max(frames_per_call // L, 1)
        for b in range(0, len(ids), per):
            chunk = ids[b:b + per]
            real = sum(lengths[i] for i in chunk)
            calls.append(Call(chunk + [chunk[-1]] * (per - len(chunk)), L,
                              real, len(chunk)))
    order = torch.randperm(len(calls), generator=g).tolist()
    return [calls[i] for i in order]


def pad_tracklet(x: torch.Tensor, T: int, L: int, value=None
                 ) -> torch.Tensor:
    """A tracklet's per-frame tensor ``[T, ...]`` padded to ``L`` frames:
    the last frame repeated, or ``value`` where given."""
    if T == L:
        return x
    if value is None:
        rep = x[-1:].expand((L - T,) + tuple(x.shape[1:]))
    else:
        rep = torch.full((L - T,) + tuple(x.shape[1:]), value,
                         dtype=x.dtype, device=x.device)
    return torch.cat([x, rep], 0)


def call_tensors(tr: Tracklets, call: Call) -> dict:
    """The padded ``[B, L, ...]`` tensors of one call, on the pool's
    device: the predict inputs and the occupancy queries."""
    rows = {k: [] for k in ("points", "points_mask", "rois", "roi_scores",
                            "frame_inds", "queries")}
    for i in call.ids:
        s, T = tr.start[i], tr.length[i]
        sl = slice(s, s + T)
        rows["points"].append(pad_tracklet(tr.points[sl], T, call.L))
        rows["points_mask"].append(
            pad_tracklet(tr.points_mask[sl], T, call.L, False))
        rows["rois"].append(pad_tracklet(tr.rois[sl], T, call.L))
        rows["roi_scores"].append(pad_tracklet(tr.roi_scores[sl], T, call.L))
        rows["queries"].append(pad_tracklet(tr.queries[sl], T, call.L))
        rows["frame_inds"].append(torch.arange(
            call.L, dtype=torch.int32, device=tr.points.device))
    return {k: torch.stack(v, 0) for k, v in rows.items()}


def train_batch(tr: Tracklets, ids: list, L: int) -> dict:
    """The ``[B, L, ...]`` training tensors of tracklets ``ids`` (each of
    ``L`` frames), every field of the port's ``TrackletBatch``."""
    def stack(x):
        return torch.stack([x[tr.start[i]:tr.start[i] + L] for i in ids], 0)

    B = len(ids)
    idx = torch.tensor(ids, device=tr.points.device)
    return dict(points=stack(tr.points), points_mask=stack(tr.points_mask),
                rois=stack(tr.rois), roi_scores=stack(tr.roi_scores),
                frame_inds=torch.arange(L, dtype=torch.int32,
                                        device=tr.points.device).expand(
                                            B, L).contiguous(),
                gt_boxes=stack(tr.gt_boxes), gt_valid=stack(tr.gt_valid),
                occ_points=tr.occ_points[idx], occ_labels=tr.occ_labels[idx],
                occ_mask=torch.ones(tr.occ_labels[idx].shape,
                                    dtype=torch.bool,
                                    device=tr.points.device),
                occ_score=tr.occ_score[idx])


def make_frames(mix: dict, max_points: int, pc_range, seed: int, device,
                labels: bool = False) -> list:
    """``mix["frames"]`` LiDAR frames in ``max_points`` slots: ``(points
    [max_points, 3 + feat_dim], mask [max_points])`` each, drawn on
    ``device`` by casting the rays of a spinning LiDAR into a scene. With
    ``labels`` each frame also carries its objects' boxes and classes
    (``object_boxes``); the frames are the same.

    The sensor (``mix["lidar"]``) sits ``height_m`` over flat ground at
    the origin and fires ``beams`` x ``azimuths`` rays, the beams evenly
    spaced over ``elevation_deg``, each beam at a seeded azimuth offset.
    A ray returns at its first hit, within ``max_range_m`` and the range
    of the grid: the ground, a wall, or an object. The scene: per azimuth
    sector (``mix["walls"]``) a wall at a stratified distance and a seeded
    height, a stratified share of the sectors open; objects
    (``mix["objects"]``: box sizes and counts) standing on the ground at
    stratified ranges, seeded bearings and yaws. A return is dropped with
    probability ``drop`` and its range jittered by ``range_noise_m``.
    Every seed draws the same wall distances, open share and object
    ranges, so about the same number of points and pillars."""
    lid, wal, obj = mix["lidar"], mix["walls"], mix["objects"]
    dev = device
    g = generator(seed, 3, dev)
    g_cpu = generator(seed, 6, "cpu")
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    hi = torch.tensor(pc_range[3:], dtype=torch.float32, device=dev)
    B, A, h = lid["beams"], lid["azimuths"], float(lid["height_m"])
    el = torch.deg2rad(torch.linspace(*lid["elevation_deg"], B,
                                      device=dev))
    tan = torch.tan(el)[:, None].expand(B, A)
    S = wal["sectors"]
    sizes = torch.tensor([s for s, n in zip(obj["sizes"], obj["counts"])
                          for _ in range(n)], dtype=torch.float32,
                         device=dev)
    N, fd = len(sizes), mix["feat_dim"]
    classes = torch.tensor([i for i, n in enumerate(obj["counts"])
                            for _ in range(n)], device=dev)
    out = []
    for _ in range(mix["frames"]):
        phi = (torch.arange(A, device=dev)[None]
               + torch.rand((B, 1), generator=g, device=dev)) * (
                   2 * math.pi / A)
        c, s = torch.cos(phi), torch.sin(phi)
        # the ground, then each sector's wall
        t = torch.where(tan < 0, h / (-tan).clamp(min=1e-9), math.inf)
        wlo, whi = wal["range_m"]
        dist = (wlo + (whi - wlo) * strata(S, g_cpu)).to(dev, torch.float32)
        dist = torch.where(strata(S, g_cpu).to(dev) < wal["open"], math.inf,
                           dist)
        height = _uniform(g, (S,), *wal["height_m"], dev)
        sec = (phi * (S / (2 * math.pi))).long() % S
        tw = dist[sec]
        zw = h + tw * tan
        t = torch.where((zw <= height[sec]) & (tw < t), tw, t)
        # objects: boxes on the ground, [length, width, height]
        olo, ohi = obj["range_m"]
        rng = (olo ** 2 + (ohi ** 2 - olo ** 2) * strata(N, g_cpu)).sqrt()
        ang = _uniform(g, (N,), -math.pi, math.pi, dev)
        ctr = torch.stack([torch.cos(ang), torch.sin(ang)], -1) * rng.to(
            dev, torch.float32)[:, None]
        yaw = _uniform(g, (N,), -math.pi, math.pi, dev)
        boxes = object_boxes(ctr, yaw, sizes) if labels else None
        for k in range(N):
            cy, sy = torch.cos(yaw[k]), torch.sin(yaw[k])
            # the ray from the origin in the box's frame
            ox = -(ctr[k, 0] * cy + ctr[k, 1] * sy)
            oy = ctr[k, 0] * sy - ctr[k, 1] * cy
            dx, dy = c * cy + s * sy, -c * sy + s * cy
            half = sizes[k, :2] / 2
            tin, tout = None, None
            for o, d, e in ((ox, dx, half[0]), (oy, dy, half[1])):
                d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
                t1, t2 = (-e - o) / d, (e - o) / d
                a, b = torch.minimum(t1, t2), torch.maximum(t1, t2)
                tin = a if tin is None else torch.maximum(tin, a)
                tout = b if tout is None else torch.minimum(tout, b)
            # a descending ray may first reach the box through its roof
            roof = torch.where(tan < 0, (h - sizes[k, 2])
                               / (-tan).clamp(min=1e-9), math.inf)
            roof = torch.where(h <= sizes[k, 2], 0.0, roof)
            th = torch.maximum(tin, roof)
            hit = (tin < tout) & (th > 0) & (th <= tout)
            t = torch.where(hit & (th < t), th, t)
        r3 = t * torch.sqrt(1 + tan * tan)
        t = t + lid["range_noise_m"] * torch.randn(
            (B, A), generator=g, device=dev) / torch.sqrt(1 + tan * tan)
        xyz = torch.stack([t * c, t * s, h + t * tan], -1)
        keep = (torch.isfinite(r3) & (r3 <= lid["max_range_m"])
                & (torch.rand((B, A), generator=g, device=dev) >= lid["drop"])
                & ((xyz >= lo) & (xyz < hi)).all(-1))
        pts = xyz[keep]
        if len(pts) > max_points:
            pick = torch.randperm(len(pts), generator=g, device=dev)
            pts = pts[pick[:max_points].sort().values]
        n = len(pts)
        feats = torch.rand((n, fd), generator=g, device=dev)
        points = torch.zeros((max_points, 3 + fd), device=dev)
        points[:n] = torch.cat([pts, feats], -1)
        mask = torch.arange(max_points, device=dev) < n
        out.append((points, mask) if boxes is None else
                   (points, mask, boxes, classes))
    return out


def object_boxes(ctr: torch.Tensor, yaw: torch.Tensor, sizes: torch.Tensor
                 ) -> torch.Tensor:
    """The objects of ``make_frames`` as the port's boxes ``[N, 7]``: ``(x,
    y, z_bottom, w, l, h, yaw)``, whose ``l`` lies along the angle pi/2 -
    yaw and ``w`` across it (``core/boxes.py::corners_3d``: the box frame
    turned by -yaw). An object ``[length, width, height]`` long along its
    heading ``phi`` stands on the ground (z = 0): its box has ``w`` its
    width, ``l`` its length and the yaw pi/2 - phi, in [-pi, pi)."""
    turned = torch.remainder(math.pi / 2 - yaw + math.pi, 2 * math.pi) \
        - math.pi
    return torch.cat([ctr, torch.zeros_like(ctr[:, :1]), sizes[:, 1:2],
                      sizes[:, 0:1], sizes[:, 2:3], turned[:, None]], -1)


def frame_labels(boxes: torch.Tensor, classes: torch.Tensor, pc_range,
                 max_gt: int) -> dict:
    """A frame's training labels: the boxes whose centre lies inside
    ``pc_range`` (x and y), in order, padded to ``max_gt``: ``gt_boxes
    [max_gt, 7]``, ``gt_labels [max_gt]`` int32 (each box's size row),
    ``gt_valid [max_gt]``."""
    xy = boxes[:, :2]
    lo = torch.tensor(pc_range[:2], device=xy.device)
    hi = torch.tensor(pc_range[3:5], device=xy.device)
    keep = ((xy >= lo) & (xy < hi)).all(-1)
    b, c = boxes[keep][:max_gt], classes[keep][:max_gt]
    n = len(b)
    out = dict(gt_boxes=torch.zeros(max_gt, 7, device=xy.device),
               gt_labels=torch.zeros(max_gt, dtype=torch.int32,
                                     device=xy.device),
               gt_valid=torch.arange(max_gt, device=xy.device) < n)
    out["gt_boxes"][:n] = b
    out["gt_labels"][:n] = c.to(torch.int32)
    return out
