"""``traffic.make_frames`` as it stood before it could return its
objects' boxes beside the frames: the oracle that the frames of
``sst.detect`` stay the same, bit for bit."""
from __future__ import annotations

import math

import torch

from portbench.traffic import _uniform, generator, strata


def make_frames(mix: dict, max_points: int, pc_range, seed: int, device
                ) -> list:
    """``mix["frames"]`` LiDAR frames in ``max_points`` slots: ``(points
    [max_points, 3 + feat_dim], mask [max_points])`` each, drawn on
    ``device`` by casting the rays of a spinning LiDAR into a scene.

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
        out.append((points, mask))
    return out
