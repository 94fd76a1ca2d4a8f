"""Waymo leaderboard submission packaging + empty-prediction filtering: a
copy of the JAX package's ``evalx/submission.py`` (host-only numpy and
protobuf wire bytes; the port imports nothing of that package).

Replaces two pieces of the reference's submission flow:

* the prebuilt ``create_submission`` binary (``tools/create_submission``,
  referenced by ``docs/overall_instructions.md:120``): wraps a results
  ``.bin`` (serialized ``waymo.open_dataset.Objects``) into sharded
  ``waymo.open_dataset.Submission`` protos plus a ``.tar.gz`` — the format
  the Waymo challenge server ingests;
* ``tools/ctrl/remove_empty.py``: drops predicted boxes that contain no
  LiDAR points before submission (the leaderboard penalizes phantom boxes).

The ``Submission`` schema below was extracted from the official binary's
embedded ``FileDescriptorProto`` (waymo_open_dataset/protos/submission.proto):

  Submission { Task task = 1; string unique_method_name = 2;
               repeated string authors = 3; string affiliation = 4;
               string description = 5; string method_link = 6;
               int32 number_past_frames_exclude_current = 9;
               int32 number_future_frames_exclude_current = 10;
               Objects inference_results = 11; SensorType sensor_type = 12;
               string account_name = 13; repeated Label.Type object_types = 14;
               float latency_second = 15; }
  Task { UNKNOWN=0 DETECTION_2D=1 DETECTION_3D=2 TRACKING_2D=3
         TRACKING_3D=4 DOMAIN_ADAPTATION=5 }
  SensorType { INVALID=0 LIDAR_ALL=1 LIDAR_TOP=2 CAMERA_ALL=3
               CAMERA_LIDAR_TOP=4 CAMERA_LIDAR_ALL=5 }
"""
from __future__ import annotations

import os
import tarfile
from dataclasses import dataclass, field

import numpy as np

from .waymo_bin import (_bytes, _float, _int, _parse_fields, _read_varint)

TASK_DETECTION_3D = 2
TASK_TRACKING_3D = 4
SENSOR_LIDAR_ALL = 1


@dataclass
class SubmissionMeta:
    unique_method_name: str
    account_name: str = ""
    authors: list = field(default_factory=list)
    affiliation: str = ""
    description: str = ""
    method_link: str = ""
    task: int = TASK_DETECTION_3D
    sensor_type: int = SENSOR_LIDAR_ALL
    num_past_frames: int = 0
    num_future_frames: int = 0
    object_types: list = field(default_factory=list)  # waymo Label.Type ids
    latency_second: float = 0.0


def iter_raw_objects(bin_path: str):
    """Yield the raw serialized ``Object`` records of a results ``.bin``
    (each already length-delimited as Objects field 1) without decoding —
    sharding re-emits the exact bytes."""
    with open(bin_path, "rb") as f:
        buf = f.read()
    i = 0
    while i < len(buf):
        key, j = _read_varint(buf, i)
        assert key >> 3 == 1 and key & 7 == 2, "not an Objects stream"
        n, j = _read_varint(buf, j)
        yield buf[i:j + n]
        i = j + n


def encode_submission(meta: SubmissionMeta, objects_payload: bytes) -> bytes:
    """Serialize one Submission proto; ``objects_payload`` is the
    concatenation of raw Object records (i.e. a serialized Objects)."""
    out = bytearray()
    out += _int(1, meta.task)
    out += _bytes(2, meta.unique_method_name.encode())
    for a in meta.authors:
        out += _bytes(3, a.encode())
    if meta.affiliation:
        out += _bytes(4, meta.affiliation.encode())
    if meta.description:
        out += _bytes(5, meta.description.encode())
    if meta.method_link:
        out += _bytes(6, meta.method_link.encode())
    out += _int(9, meta.num_past_frames)
    out += _int(10, meta.num_future_frames)
    out += _bytes(11, objects_payload)
    out += _int(12, meta.sensor_type)
    if meta.account_name:
        out += _bytes(13, meta.account_name.encode())
    for t in meta.object_types:
        out += _int(14, int(t))
    if meta.latency_second:
        out += _float(15, float(meta.latency_second))
    return bytes(out)


def detect_object_types(bin_path: str) -> list[int]:
    """The distinct Label.Type ids present in a results .bin."""
    types = set()
    for rec in iter_raw_objects(bin_path):
        # rec = key+len+Object; skip to the payload
        _, i = _read_varint(rec, 0)
        n, i = _read_varint(rec, i)
        for f2, v2 in _parse_fields(rec[i:i + n]):
            if f2 == 1:                      # Label
                for f3, v3 in _parse_fields(v2):
                    if f3 == 3:
                        types.add(int(v3))
    return sorted(types)


def create_submission(bin_path: str, out_dir: str, prefix: str,
                      meta: SubmissionMeta, num_shards: int = 4,
                      tar: bool = True) -> list[str]:
    """Shard a results .bin into ``{prefix}0..{prefix}{n-1}`` Submission
    files under ``out_dir`` (contiguous record slices) and optionally pack
    them into ``{prefix}.tar.gz`` — the official binary's output layout."""
    os.makedirs(out_dir, exist_ok=True)
    if not meta.object_types:
        meta.object_types = detect_object_types(bin_path)
    records = list(iter_raw_objects(bin_path))
    paths = []
    per = (len(records) + num_shards - 1) // max(num_shards, 1)
    for s in range(num_shards):
        payload = b"".join(records[s * per:(s + 1) * per])
        path = os.path.join(out_dir, f"{prefix}{s}")
        with open(path, "wb") as f:
            f.write(encode_submission(meta, payload))
        paths.append(path)
    if tar:
        tar_path = os.path.join(out_dir, f"{prefix}.tar.gz")
        with tarfile.open(tar_path, "w:gz") as tf:
            for p in paths:
                tf.add(p, arcname=os.path.basename(p))
        paths.append(tar_path)
    return paths


def read_submission(path: str) -> dict:
    """Decode a Submission file (round-trip testing)."""
    with open(path, "rb") as f:
        buf = f.read()
    out = {"authors": [], "object_types": [], "objects_payload": b""}
    names = {1: "task", 2: "unique_method_name", 4: "affiliation",
             5: "description", 6: "method_link", 9: "num_past_frames",
             10: "num_future_frames", 12: "sensor_type",
             13: "account_name", 15: "latency_second"}
    for f2, v2 in _parse_fields(buf):
        if f2 == 3:
            out["authors"].append(v2.decode())
        elif f2 == 11:
            out["objects_payload"] += v2
        elif f2 == 14:
            out["object_types"].append(int(v2))
        elif f2 in names:
            out[names[f2]] = v2.decode() if isinstance(v2, bytes) else v2
    return out


def remove_empty_predictions(bin_path: str, out_path: str, get_points,
                             min_points: int = 1) -> tuple[int, int]:
    """``tools/ctrl/remove_empty.py`` semantics: for every (segment, ts)
    frame in the results .bin, count LiDAR points inside each predicted box
    and drop boxes with fewer than ``min_points``.

    ``get_points(context_name, timestamp) -> [N, >=3] ego-frame points``.
    Returns (kept, total)."""
    from collections import defaultdict

    from .waymo_bin import read_bin

    def inbox_counts(pts, boxes):
        """[N,3] points x [R,7] waymo boxes (gravity cx,cy,cz, W, L, H,
        heading = world angle of the LENGTH axis) -> [R] point counts.

        The test runs directly in the waymo frame — no internal-layout
        conversion, so there is exactly one rotation convention in play."""
        if len(pts) == 0 or len(boxes) == 0:
            return np.zeros(len(boxes), np.int64)
        d = pts[None, :, :2] - boxes[:, None, :2]          # [R, N, 2]
        c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
        ll = d[..., 0] * c[:, None] + d[..., 1] * s[:, None]   # along length
        lw = -d[..., 0] * s[:, None] + d[..., 1] * c[:, None]  # along width
        lz = pts[None, :, 2] - boxes[:, None, 2]
        inside = ((np.abs(ll) <= boxes[:, None, 4] / 2)
                  & (np.abs(lw) <= boxes[:, None, 3] / 2)
                  & (np.abs(lz) <= boxes[:, None, 5] / 2))
        return inside.sum(1)

    records = list(iter_raw_objects(bin_path))
    decoded = read_bin(bin_path)
    assert len(records) == len(decoded)
    by_frame = defaultdict(list)
    for i, rec in enumerate(decoded):
        by_frame[(rec["context_name"], rec["timestamp"])].append(i)

    keep = np.zeros(len(records), bool)
    for (ctx, ts), idxs in by_frame.items():
        pts = np.asarray(get_points(ctx, ts))[:, :3]
        # decoded box = {field number: value}: 1..7 = cx,cy,cz,W,L,H,heading
        boxes = [[decoded[i]["box"].get(k, 0.0) for k in range(1, 8)]
                 for i in idxs]
        boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
        counts = inbox_counts(pts, boxes)
        for i, c in zip(idxs, counts):
            keep[i] = c >= min_points
    with open(out_path, "wb") as f:
        for i, rec in enumerate(records):
            if keep[i]:
                f.write(rec)
    return int(keep.sum()), len(records)
