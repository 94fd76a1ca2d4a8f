"""Host-side (numpy) geometry for the tracklet data pipeline (a copy of
the JAX package's ``data/np_geometry.py``; the port imports nothing of that
package). Same conventions as ``core/boxes.py``. Used for GT-candidate
selection and the pipeline transforms.
"""
from __future__ import annotations

import numpy as np


def rotate_z(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    c = np.cos(angles)[..., None]
    s = np.sin(angles)[..., None]
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    ox = x * c + y * s
    oy = -x * s + y * c
    return np.concatenate([ox, oy, np.broadcast_to(z, ox.shape)], axis=-1)


def _corners_bev(boxes: np.ndarray) -> np.ndarray:
    w, l, yaw = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    sx = np.stack([w, -w, -w, w], -1) * 0.5
    sy = np.stack([l, l, -l, -l], -1) * 0.5
    c, s = np.cos(yaw)[..., None], np.sin(yaw)[..., None]
    x = sx * c - sy * s + boxes[..., None, 0]
    y = sx * s + sy * c + boxes[..., None, 1]
    return np.stack([x, y], -1)


def _clip_area(subject: np.ndarray, clip: np.ndarray) -> float:
    """Sutherland–Hodgman intersection area of two convex CCW polygons."""
    poly = list(subject)
    for k in range(len(clip)):
        if not poly:
            return 0.0
        a, b = clip[k], clip[(k + 1) % len(clip)]
        ab = b - a
        out = []
        n = len(poly)
        for i in range(n):
            cur, nxt = poly[i], poly[(i + 1) % n]
            s_cur = ab[0] * (cur[1] - a[1]) - ab[1] * (cur[0] - a[0])
            s_nxt = ab[0] * (nxt[1] - a[1]) - ab[1] * (nxt[0] - a[0])
            if s_cur >= 0:
                out.append(cur)
            if (s_cur >= 0) != (s_nxt >= 0):
                t = s_cur / (s_cur - s_nxt)
                out.append(cur + t * (nxt - cur))
        poly = out
    if len(poly) < 3:
        return 0.0
    v = np.asarray(poly)
    x, y = v[:, 0], v[:, 1]
    return 0.5 * abs(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def aligned_iou_3d(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Paired rotated 3D IoU, numpy (see core.boxes.aligned_iou_3d)."""
    boxes1 = np.atleast_2d(boxes1)
    boxes2 = np.atleast_2d(boxes2)
    c1 = _corners_bev(boxes1)
    c2 = _corners_bev(boxes2)
    out = np.zeros(boxes1.shape[0], np.float64)
    for i in range(boxes1.shape[0]):
        # cheap reject: BEV circumscribed circles
        r = 0.5 * (np.hypot(boxes1[i, 3], boxes1[i, 4])
                   + np.hypot(boxes2[i, 3], boxes2[i, 4]))
        if np.hypot(*(boxes1[i, :2] - boxes2[i, :2])) > r:
            continue
        inter_bev = _clip_area(c1[i], c2[i])
        top = min(boxes1[i, 2] + boxes1[i, 5], boxes2[i, 2] + boxes2[i, 5])
        bot = max(boxes1[i, 2], boxes2[i, 2])
        inter = inter_bev * max(top - bot, 0.0)
        v1 = boxes1[i, 3] * boxes1[i, 4] * boxes1[i, 5]
        v2 = boxes2[i, 3] * boxes2[i, 4] * boxes2[i, 5]
        out[i] = inter / max(v1 + v2 - inter, 1e-8)
    return out
