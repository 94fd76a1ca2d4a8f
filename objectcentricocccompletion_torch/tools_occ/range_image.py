"""Virtual range-image construction (W0 core math): a copy of the JAX
package's ``tools_occ/range_image.py`` (the port imports nothing of that
package).

Rebuild of the raw-frame extraction the annotator consumes
(``tools/data_converter/waymo_converter.py:549-676``, which calls
waymo_open_dataset's ``build_range_image_from_point_cloud``): project ego-
frame points into a sensor's (row, col) grid — row by nearest beam
inclination, col by azimuth with the extrinsic correction — and keep the
minimum range per cell, merging both LiDAR returns into one "virtual" range
image free of rolling-shutter artifacts.

Pure numpy so it is testable without tensorflow/waymo deps; the tfrecord
CLI wrapper lives in ``waymo_raw_converter.py``.
"""
from __future__ import annotations

import numpy as np


def project_to_range_image(points_ego: np.ndarray, extrinsic: np.ndarray,
                           inclinations: np.ndarray, width: int
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ego points -> (rows, cols, ranges) in a [H, width] sensor grid.

    ``inclinations`` must be ascending (flip Waymo's stored order first).
    Mirrors ``point_cloud_to_range_image_idx``
    (``tools/occ/occ_annotate.py:141-201``).
    """
    inv = np.linalg.inv(extrinsic)
    pts = points_ego @ inv[:3, :3].T + inv[:3, 3]
    xy = np.linalg.norm(pts[:, :2], axis=-1)
    incl = np.arctan2(pts[:, 2], xy)
    rows = np.argmin(np.abs(incl[:, None] - inclinations[None, :]), axis=-1)

    az_corr = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    az = np.arctan2(pts[:, 1], pts[:, 0]) + az_corr
    az = np.where(az > np.pi, az - 2 * np.pi, az)
    az = np.where(az < -np.pi, az + 2 * np.pi, az)
    cols = np.round(width - 0.5 - (az + np.pi) / (2 * np.pi) * width)
    cols = np.mod(cols, width).astype(np.int64)
    ranges = np.linalg.norm(pts, axis=-1)
    return rows.astype(np.int64), cols, ranges


def rollpitchyaw_to_matrices(pose6: np.ndarray
                             ) -> tuple[np.ndarray, np.ndarray]:
    """[N, 6] (roll, pitch, yaw, x, y, z) -> ([N, 3, 3] R = Rz Ry Rx,
    [N, 3] t) — the waymo ``range_image_top_pose`` encoding."""
    roll, pitch, yaw = pose6[:, 0], pose6[:, 1], pose6[:, 2]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.empty((len(pose6), 3, 3))
    R[:, 0, 0] = cy * cp
    R[:, 0, 1] = cy * sp * sr - sy * cr
    R[:, 0, 2] = cy * sp * cr + sy * sr
    R[:, 1, 0] = sy * cp
    R[:, 1, 1] = sy * sp * sr + cy * cr
    R[:, 1, 2] = sy * sp * cr - cy * sr
    R[:, 2, 0] = -sp
    R[:, 2, 1] = cp * sr
    R[:, 2, 2] = cp * cr
    return R, pose6[:, 3:6]


def range_image_to_points(ri_range: np.ndarray, extrinsic: np.ndarray,
                          inclinations: np.ndarray,
                          pixel_pose: np.ndarray | None = None,
                          frame_pose: np.ndarray | None = None
                          ) -> np.ndarray:
    """Inverse of :func:`project_to_range_image`: a [H, W] range image ->
    ego-frame xyz points (cells with range <= 0 are dropped).

    ``inclinations`` [H] must be aligned with the image rows (Waymo stores
    row 0 = highest beam, i.e. descending).

    Rolling-shutter pose correction (official
    ``extract_point_cloud_from_range_image`` semantics, used by the
    reference converter via ``range_image_top_pose``,
    ``tools/data_converter/waymo_converter.py:660-670``): when
    ``pixel_pose`` [H, W, 6] (roll/pitch/yaw/xyz per pixel, world frame)
    and ``frame_pose`` [4, 4] are given, each point moves
    vehicle -> world via its own pixel pose and back to the frame's
    vehicle pose — pixels whose pose row is all-zero stay uncorrected.
    """
    H, W = ri_range.shape
    az_corr = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    cols = np.arange(W)
    az = (W - 0.5 - cols) / W * 2.0 * np.pi - np.pi - az_corr
    az = np.where(az > np.pi, az - 2 * np.pi, az)
    az = np.where(az < -np.pi, az + 2 * np.pi, az)
    ci = np.cos(inclinations)[:, None]
    si = np.sin(inclinations)[:, None]
    dirs = np.stack([ci * np.cos(az)[None, :], ci * np.sin(az)[None, :],
                     np.broadcast_to(si, (H, W))], -1)      # [H, W, 3]
    valid = ri_range > 0
    pts_sensor = dirs[valid] * ri_range[valid][:, None]
    pts = pts_sensor @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    if pixel_pose is None or frame_pose is None:
        return pts
    pp = np.asarray(pixel_pose)[valid]                      # [N, 6]
    has_pose = np.any(pp != 0, axis=-1)
    R, t = rollpitchyaw_to_matrices(pp)
    world = np.einsum("nij,nj->ni", R, pts) + t
    inv = np.linalg.inv(frame_pose)
    corrected = world @ inv[:3, :3].T + inv[:3, 3]
    return np.where(has_pose[:, None], corrected, pts)


def build_virtual_range_image(points_ego: np.ndarray, extrinsic: np.ndarray,
                              inclinations: np.ndarray, width: int,
                              fill: float = 0.0) -> np.ndarray:
    """Scatter-min of point ranges into [H, width]; empty cells = ``fill``.

    Merging the points of both returns gives the
    ``*_RANGE_IMAGE_MERGE_VIRTUAL`` map the annotator ray-casts against.
    """
    H = len(inclinations)
    rows, cols, ranges = project_to_range_image(points_ego, extrinsic,
                                                inclinations, width)
    ri = np.full((H, width), np.inf)
    np.minimum.at(ri, (rows, cols), ranges)
    ri[~np.isfinite(ri)] = fill
    return ri.astype(np.float32)
