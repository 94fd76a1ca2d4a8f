"""Offline object-centric occupancy GT annotation (W1): the counterpart of
the JAX package's ``tools_occ/annotate.py``, with its visibility test on
the annotator's device (``cuda`` unless the caller asks for the CPU).

For each vehicle tracklet (reference ``tools/occ/occ_annotate.py:91-647``):
  1. gather the in-box points of every frame in the box-local frame
     ``local = rotate_z(p - bottom_center, -yaw)`` (host numpy),
  2. voxelize the aggregated cloud on a grid of ``ceil(max_size / voxel)``
     cells spanning ``[-w/2, w/2] x [-l/2, l/2] x [0, h]`` (host numpy),
  3. ray-cast every non-occupied voxel centre against the virtual range
     images of every LiDAR over every frame: a voxel seen *through* by any
     sensor in any frame is free; voxels with points are occupied; the rest
     unknown (``_range_image_visibility``, torch on the device),
  4. save ``<out>/<segment>/<trk_id>.npz`` with ``occ[X, Y, Z]`` int32 in
     {0 unknown, 1 occupied, 2 free}.

The visibility test is the JAX function's arithmetic in float32, op for op:
the inverse extrinsic by ``torch.linalg.inv``, the nearest beam by an
``argmin`` over the dense ``[T, N, H]`` distances (the first index wins a
tie, on both packages), the azimuth column rounded half to even and
wrapped by ``torch.remainder`` (the divisor's sign, as ``jnp.mod``). The
sensor coordinates and norms are written out as single multiplies and adds,
and the column's division divides by a device tensor (CUDA multiplies by
the reciprocal of a host scalar divisor), so that the card and the CPU
round the same way everywhere but in ``cos``, ``sin``, ``atan2`` and the
inverse. Inputs are cast to float32 on the host, as the JAX code's
``jnp.asarray(..., jnp.float32)`` does.

The JAX code pads each chunk of voxels to a power of two so that XLA
compiles few static shapes. Eager torch needs no bucket and a voxel's
answer does not depend on its chunk, so the port runs the exact count, in
chunks of ``voxel_chunk`` voxels that bound the ``[T, N, H]`` intermediate.

Two runs (two devices, or this package and the JAX one) may disagree on a
voxel only where a decision lies within ``MARGIN_ULPS`` float32 ulps of its
boundary: the midpoint between two beams, a half-integer column, or
``ri_val == rng``. ``decision_margins`` recomputes the decisions in float64
on the host, and ``unexplained`` / ``grid_differences`` apply that rule.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from ..utils.device import resolve_device

LIDAR_NAMES = ("TOP", "FRONT", "SIDE_LEFT", "SIDE_RIGHT", "REAR")
# float32 ulps within which a decision may go either way between two runs
MARGIN_ULPS = 4


def local_frame_points(points_ego: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Ego points -> box-local (bottom-center origin, yaw-aligned)."""
    d = points_ego - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    return np.stack([d[:, 0] * c + d[:, 1] * s,
                     -d[:, 0] * s + d[:, 1] * c,
                     d[:, 2]], -1)


def points_in_box_mask(points_ego: np.ndarray, box: np.ndarray) -> np.ndarray:
    local = local_frame_points(points_ego, box)
    half = box[3:6] / 2
    return (np.abs(local[:, 0]) <= half[0]) & \
           (np.abs(local[:, 1]) <= half[1]) & \
           (np.abs(local[:, 2] - half[2]) <= half[2])


def _sensor_points(centers_local, boxes, extrinsics):
    """Box-local voxel centres [N, 3] -> each frame's ego frame, then its
    sensor frame: ([T, N, 3] ego, [T, N, 3] sensor). Works on torch tensors
    and numpy arrays alike."""
    lib = torch if isinstance(boxes, torch.Tensor) else np
    yaw = boxes[:, 6]
    c, s = lib.cos(yaw)[:, None], lib.sin(yaw)[:, None]
    x, y, z = centers_local[:, 0][None], centers_local[:, 1][None], \
        centers_local[:, 2][None]
    ex = x * c + y * s + boxes[:, 0:1]
    ey = -x * s + y * c + boxes[:, 1:2]
    ez = z + boxes[:, 2:3]
    inv = lib.linalg.inv(extrinsics)
    cols = [inv[:, i:i + 1] for i in range(3)]
    pts = [r[..., 0] * ex + r[..., 1] * ey + r[..., 2] * ez + r[..., 3]
           for r in cols]
    return (ex, ey, ez), pts


def _range_image_visibility(centers_local: torch.Tensor, boxes: torch.Tensor,
                            extrinsics: torch.Tensor,
                            inclinations: torch.Tensor,
                            range_images: torch.Tensor) -> torch.Tensor:
    """Visibility of voxel centres against one sensor's range images.

    centers_local: [N, 3] box-local voxel centres (z from the bottom).
    boxes: [T, 7] per-frame ego boxes. extrinsics: [T, 4, 4].
    inclinations: [T, H] (already flipped to ascending row order).
    range_images: [T, H, W]. All float32 on one device. Returns [N] int32:
    2 (free) where some frame's ray passes the centre, else 0. Mirrors
    ``point_cloud_to_range_image_idx`` and the ``>=`` range test.
    """
    width = range_images.shape[-1]
    _, (px, py, pz) = _sensor_points(centers_local, boxes, extrinsics)
    xy_norm = torch.sqrt(px * px + py * py)
    incl = torch.atan2(pz, xy_norm)                               # [T, N]
    # row: the nearest beam inclination (first index on a tie)
    diff = torch.abs(incl[:, :, None] - inclinations[:, None, :])
    rows = torch.argmin(diff, dim=-1)                             # [T, N]

    az_corr = torch.atan2(extrinsics[:, 1, 0], extrinsics[:, 0, 0])
    az = torch.atan2(py, px) + az_corr[:, None]
    az = torch.where(az > math.pi, az - 2 * math.pi, az)
    az = torch.where(az < -math.pi, az + 2 * math.pi, az)
    two_pi = torch.tensor(2 * math.pi, dtype=az.dtype, device=az.device)
    cols = torch.round((width - 0.5) - (az + math.pi) / two_pi * width)
    cols = torch.remainder(cols, width).to(torch.int64)

    rng = torch.sqrt(px * px + py * py + pz * pz)
    t_idx = torch.arange(range_images.shape[0],
                         device=range_images.device)[:, None]
    ri_val = range_images[t_idx, rows, cols]                      # [T, N]
    visible = ri_val >= rng
    return torch.where(visible.any(0), 2, 0).to(torch.int32)


def _ulp32(x: np.ndarray) -> np.ndarray:
    """float32's step at |x| (float64)."""
    return np.spacing(np.abs(np.asarray(x, np.float64)).astype(np.float32)
                      ).astype(np.float64)


def decision_margins(centers_local: np.ndarray, boxes: np.ndarray,
                     extrinsics: np.ndarray, inclinations: np.ndarray,
                     range_images: np.ndarray, ulps: int = MARGIN_ULPS
                     ) -> tuple[np.ndarray, np.ndarray]:
    """One sensor's decisions recomputed in float64 on the host, from the
    float32 inputs of ``_range_image_visibility`` (same argument layout,
    numpy): ``(visible [T, N], near [T, N])``. ``near`` marks the frames
    where a decision lies within ``ulps`` float32 ulps of its boundary,
    counted in the quantities that feed it:

    * the beam: the inclination's distance to the midpoint of the nearest
      two beams, against the ulps of the inclinations and of the point's
      coordinates over its horizontal range;
    * the column: the distance to a half-integer column, against the ulps
      of the width (the operands of the last subtraction) and of the
      azimuth and the coordinates over the horizontal range;
    * the range: ``ri_val - rng``, against the ulps of both and of the
      coordinates.
    """
    f64 = lambda a: np.asarray(a, np.float32).astype(np.float64)  # noqa
    centers, boxes, extr = f64(centers_local), f64(boxes), f64(extrinsics)
    incls, ri = f64(inclinations), f64(range_images)
    width = ri.shape[-1]
    (ex, ey, ez), (px, py, pz) = _sensor_points(centers, boxes, extr)
    pos_ulp = _ulp32(np.maximum.reduce([np.abs(a) for a in
                                        (ex, ey, ez, px, py, pz)]))
    xy = np.sqrt(px * px + py * py)
    rng = np.sqrt(px * px + py * py + pz * pz)
    incl = np.arctan2(pz, xy)
    d = np.abs(incl[:, :, None] - incls[:, None, :])
    order = np.argsort(d, axis=-1, kind="stable")
    rows = order[..., 0]
    b1 = np.take_along_axis(incls[:, None, :], order[..., :1], -1)[..., 0]
    b2 = np.take_along_axis(incls[:, None, :], order[..., 1:2], -1)[..., 0]
    d1 = np.take_along_axis(d, order[..., :1], -1)[..., 0]
    d2 = np.take_along_axis(d, order[..., 1:2], -1)[..., 0]
    ang_ulp = pos_ulp / np.maximum(xy, 1e-12)
    near_beam = (d2 - d1) / 2 <= ulps * (
        _ulp32(np.maximum(np.abs(b1), np.abs(b2))) + ang_ulp)

    az_corr = np.arctan2(extr[:, 1, 0], extr[:, 0, 0])
    az = np.arctan2(py, px) + az_corr[:, None]
    az = np.where(az > np.pi, az - 2 * np.pi, az)
    az = np.where(az < -np.pi, az + 2 * np.pi, az)
    col_f = (width - 0.5) - (az + np.pi) / (2 * np.pi) * width
    to_half = np.abs(col_f - np.floor(col_f) - 0.5)
    near_col = to_half <= ulps * (_ulp32(width) + (_ulp32(np.pi) + ang_ulp)
                                  * width / (2 * np.pi))
    cols = np.mod(np.round(col_f), width).astype(np.int64)

    t_idx = np.arange(ri.shape[0])[:, None]
    ri_val = ri[t_idx, rows, cols]
    near_range = np.abs(ri_val - rng) <= ulps * np.maximum.reduce(
        [_ulp32(ri_val), _ulp32(rng), pos_ulp])
    return ri_val >= rng, near_beam | near_col | near_range


def unexplained(vis_a: np.ndarray, vis_b: np.ndarray, decisions) -> np.ndarray:
    """[N] bool: voxels whose visibility (2 / 0) differs between two runs
    in a way the margin rule does not allow. A difference is allowed where
    no (sensor, frame) decides "visible" away from a boundary and some
    decision lies near one: only a near decision can tip the any over
    frames. ``decisions``: ``decision_margins``' pairs of every sensor."""
    confident = np.zeros(len(vis_a), bool)
    near_any = np.zeros(len(vis_a), bool)
    for visible, near in decisions:
        confident |= (visible & ~near).any(0)
        near_any |= near.any(0)
    return (np.asarray(vis_a) != np.asarray(vis_b)) & (confident | ~near_any)


def staged_inputs(frame: dict, name: str) -> tuple:
    """One frame's float32 (extrinsic [4, 4], inclinations flipped to
    ascending row order [H], range image [H, W]) of sensor ``name``, cast
    on the host."""
    return (np.asarray(frame[f"{name}_LIDAR_EXTRINSIC"], np.float32),
            np.flip(np.asarray(frame[f"{name}_BEAM_INCLINATION"],
                               np.float32)).copy(),
            np.asarray(frame[f"{name}_RANGE_IMAGE_MERGE_VIRTUAL"],
                       np.float32))


def grid_differences(occ_a: np.ndarray, occ_b: np.ndarray,
                     boxes: np.ndarray, frames: list, voxel_size: float,
                     lidar_names=LIDAR_NAMES) -> dict:
    """Two ``annotate_trk`` grids of one tracklet (``frames``: its raw
    frames in order) held to the margin rule: ``{"differ": voxels that
    differ, "unexplained": those the rule does not allow, "occupied_differ":
    occupied voxels that differ (the host's voxelization: must be 0)}``."""
    diff = occ_a != occ_b
    occupied_differ = int(np.sum(diff & ((occ_a == 1) | (occ_b == 1))))
    idx = np.stack(np.nonzero(diff & (occ_a != 1) & (occ_b != 1)), -1)
    out = {"differ": int(diff.sum()), "occupied_differ": occupied_differ,
           "unexplained": occupied_differ}
    if not len(idx):
        return out
    size = boxes[:, 3:6].max(0)
    min_bound = np.array([-size[0] / 2, -size[1] / 2, 0.0])
    centers = ((idx + 0.5) * voxel_size + min_bound).astype(np.float32)
    decisions = []
    for name in lidar_names:
        if f"{name}_RANGE_IMAGE_MERGE_VIRTUAL" not in frames[0]:
            continue
        extr, incl, ri = (np.stack(a, 0) for a in zip(
            *[staged_inputs(f, name) for f in frames]))
        decisions.append(decision_margins(centers, boxes, extr, incl, ri))
    vis_a = occ_a[tuple(idx.T)]
    vis_b = occ_b[tuple(idx.T)]
    out["unexplained"] += int(unexplained(vis_a, vis_b, decisions).sum())
    return out


class OccAnnotator:
    """Annotates tracklets given host-side data providers.

    get_points(ts) -> [N, >=3] ego-frame points of that frame.
    get_raw_frame(ts) -> dict with ``{name}_BEAM_INCLINATION`` [H],
    ``{name}_LIDAR_EXTRINSIC`` [4,4], ``{name}_RANGE_IMAGE_MERGE_VIRTUAL``
    [H,W] for each name in ``lidar_names``.

    The visibility test runs on ``device`` (``cuda`` unless the caller asks
    for the CPU). ``timing`` accumulates the seconds of the host gather and
    voxelization (``gather_s``), of the visibility test as the host sees it
    (``visibility_s``, staging and the copy back included) and of the npz
    writes (``write_s``), and on a card the device time of the visibility
    test (``device_ms``, CUDA events).
    """

    def __init__(self, get_points, get_raw_frame, out_dir: str,
                 voxel_size: float = 0.2, min_track_len: int = 10,
                 lidar_names=LIDAR_NAMES, voxel_chunk: int = 8192,
                 overwrite: bool = False, save_mean_var: bool = False,
                 device="cuda"):
        self.get_points = get_points
        self.get_raw_frame = get_raw_frame
        self.out_dir = out_dir
        self.voxel_size = voxel_size
        self.min_track_len = min_track_len
        self.lidar_names = lidar_names
        self.voxel_chunk = voxel_chunk
        self.overwrite = overwrite
        self.save_mean_var = save_mean_var
        self.device = resolve_device(device)
        # per-(segment, ts, sensor) device cache of staged range images:
        # tracklets of one segment share frames, so each frame's [H, W]
        # image is copied to the device once (FIFO, at most 512 entries:
        # about 1.4 GB at Waymo's sizes)
        self._ri_cache: dict = {}
        self._ri_cache_cap = 512
        self.timing = dict(gather_s=0.0, visibility_s=0.0, write_s=0.0,
                           device_ms=0.0)

    def annotate_trk(self, segment_name: str, trk_id: str,
                     boxes: np.ndarray, ts_list: list) -> str | None:
        """boxes: [T, 7] per-frame ego boxes. Returns the npz path."""
        out_path = os.path.join(self.out_dir, segment_name)
        os.makedirs(out_path, exist_ok=True)
        out_name = os.path.join(out_path, f"{trk_id}.npz")
        if os.path.isfile(out_name) and not self.overwrite:
            try:
                np.load(out_name)
                return out_name
            except Exception:
                pass
        if len(ts_list) < self.min_track_len:
            return None

        # 1. aggregate in-box points in the shared box-local frame
        t0 = time.perf_counter()
        local_pts = []
        for i, ts in enumerate(ts_list):
            pc = np.asarray(self.get_points(ts))[:, :3]
            m = points_in_box_mask(pc, boxes[i])
            if m.any():
                local_pts.append(local_frame_points(pc[m], boxes[i]))
        if not local_pts:
            self.timing["gather_s"] += time.perf_counter() - t0
            return None
        agg = np.concatenate(local_pts, 0)

        # 2. voxelize on the max-size grid
        size = boxes[:, 3:6].max(0)
        dims = np.maximum(np.ceil(size / self.voxel_size).astype(np.int32), 1)
        min_bound = np.array([-size[0] / 2, -size[1] / 2, 0.0])
        coors = np.floor((agg - min_bound) / self.voxel_size).astype(np.int64)
        ok = ((coors >= 0) & (coors < dims)).all(1)
        coors = coors[ok]
        occ = np.zeros(tuple(dims), bool)
        occ[coors[:, 0], coors[:, 1], coors[:, 2]] = True

        # 3. ray-cast the non-occupied voxel centers
        unknown = np.stack(np.nonzero(~occ), -1)
        result = np.zeros(occ.shape, np.int32)
        result[occ] = 1
        self.timing["gather_s"] += time.perf_counter() - t0
        if len(unknown):
            t0 = time.perf_counter()
            centers = (unknown + 0.5) * self.voxel_size + min_bound
            vis = self._visibility(centers, boxes, ts_list, segment_name)
            result[unknown[:, 0], unknown[:, 1], unknown[:, 2]] = vis
            self.timing["visibility_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        if self.save_mean_var:
            # per-occupied-voxel mean/variance of the aggregated points
            # (reference occ_annotate.py:627-645 save_mean_var): npz gains
            # mean_var [X, Y, Z, 6] = [mean_xyz, var_xyz], zeros elsewhere
            mv = np.zeros(tuple(dims) + (6,), np.float32)
            flat = np.ravel_multi_index(coors.T, tuple(dims))
            order = np.argsort(flat, kind="stable")
            flat_s = flat[order]
            pts_s = agg[ok][order]
            uniq, start = np.unique(flat_s, return_index=True)
            sums = np.add.reduceat(pts_s, start, axis=0)
            sq = np.add.reduceat(pts_s ** 2, start, axis=0)
            cnt = np.diff(np.append(start, len(flat_s)))[:, None]
            mean = sums / cnt
            var = np.maximum(sq / cnt - mean ** 2, 0.0)
            ix = np.stack(np.unravel_index(uniq, tuple(dims)), -1)
            mv[ix[:, 0], ix[:, 1], ix[:, 2]] = np.concatenate(
                [mean, var], -1)
            np.savez(out_name, occ=result, mean_var=mv)
        else:
            np.savez(out_name, occ=result)
        self.timing["write_s"] += time.perf_counter() - t0
        return out_name

    def _staged_frame(self, segment_name: str, ts, name: str, frame: dict):
        """Device-resident (extrinsic [4,4], flipped inclination [H],
        range image [H, W]) for one frame+sensor, cached across tracklets
        of the segment (FIFO-bounded)."""
        key = (segment_name, ts, name)
        hit = self._ri_cache.get(key)
        if hit is not None:
            return hit
        staged = tuple(torch.from_numpy(a).to(self.device)
                       for a in staged_inputs(frame, name))
        if len(self._ri_cache) >= self._ri_cache_cap:
            self._ri_cache.pop(next(iter(self._ri_cache)))
        self._ri_cache[key] = staged
        return staged

    def _visibility(self, centers: np.ndarray, boxes: np.ndarray,
                    ts_list: list, segment_name: str = "") -> np.ndarray:
        frames = [self.get_raw_frame(ts) for ts in ts_list]
        dev = self.device
        vis = torch.zeros((len(centers),), dtype=torch.int32, device=dev)
        boxes_t = torch.from_numpy(np.asarray(boxes, np.float32)).to(dev)
        centers_t = torch.from_numpy(np.asarray(centers, np.float32)).to(dev)
        timed = dev.type == "cuda"
        if timed:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        for name in self.lidar_names:
            if f"{name}_RANGE_IMAGE_MERGE_VIRTUAL" not in frames[0]:
                continue
            staged = [self._staged_frame(segment_name, ts, name, f)
                      for ts, f in zip(ts_list, frames)]
            extr, incl, ri = (torch.stack(s, 0) for s in zip(*staged))
            # chunk voxels to bound the [T, N, H] intermediate
            for beg in range(0, len(centers), self.voxel_chunk):
                v = _range_image_visibility(
                    centers_t[beg:beg + self.voxel_chunk], boxes_t, extr,
                    incl, ri)
                vis[beg:beg + len(v)] = torch.maximum(
                    vis[beg:beg + len(v)], v)
        if timed:
            events[1].record()
        out = vis.cpu().numpy()
        if timed:
            self.timing["device_ms"] += events[0].elapsed_time(events[1])
        return out
