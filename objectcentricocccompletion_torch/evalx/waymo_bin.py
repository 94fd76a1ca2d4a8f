"""Waymo detection-metrics ``.bin`` writer (and reader, for tests): a copy
of the JAX package's ``evalx/waymo_bin.py``, byte for byte the same output
(the port imports nothing of that package).

Serializes predictions into ``waymo.open_dataset.Objects`` protobuf bytes —
the format consumed by the ``compute_detection_metrics_main`` C++ binary the
reference shells out to (``datasets/waymo_tracklet_dataset.py:347-370``).
Implemented directly at the protobuf wire level so no waymo_open_dataset /
generated-proto dependency is needed.

Schema subset (field numbers from waymo-open-dataset ``label.proto`` /
``protos/metrics.proto``; re-validate against the official protos whenever
the Waymo toolchain is available):

  Objects { repeated Object objects = 1; }
  Object  { Label object = 1; float score = 2; bool overlap_with_nlz = 3;
            string context_name = 4; int64 frame_timestamp_micros = 5; }
  Label   { Box box = 1; Type type = 3; string id = 4; }
  Label.Box { double center_x = 1; center_y = 2; center_z = 3;
              width = 4; length = 5; height = 6; heading = 7; }

Box conversion from this framework's LiDAR layout follows
``lidar2waymo_box`` (``waymo_tracklet_dataset.py:459-487``):
center_z += h/2 (bottom->gravity), waymo length = our l (dims[4]), waymo
width = our w (dims[3]), heading = wrap(-yaw - pi/2).
"""
from __future__ import annotations

import math
import struct
from dataclasses import dataclass

TYPE_VEHICLE = 1
TYPE_PEDESTRIAN = 2
TYPE_SIGN = 3
TYPE_CYCLIST = 4

_CLASS_TO_WAYMO = {"Car": TYPE_VEHICLE, "Pedestrian": TYPE_PEDESTRIAN,
                   "Sign": TYPE_SIGN, "Cyclist": TYPE_CYCLIST}


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v))


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def wrap_heading(h: float) -> float:
    while h < -math.pi:
        h += 2 * math.pi
    while h > math.pi:
        h -= 2 * math.pi
    return h


@dataclass
class WaymoObject:
    box: tuple          # (cx, cy, cz, w, l, h, yaw) in our LiDAR layout
    score: float
    obj_type: int
    obj_id: str
    context_name: str
    timestamp_micros: int
    # GT-only extras (Label fields 7 / 5, written when >= 0):
    num_lidar_points: int = -1
    difficulty: int = -1


def encode_object(o: WaymoObject) -> bytes:
    cx, cy, cz, w, l, h, yaw = [float(x) for x in o.box]
    box = (_double(1, cx) + _double(2, cy) + _double(3, cz + h / 2)
           + _double(4, w) + _double(5, l) + _double(6, h)
           + _double(7, wrap_heading(-yaw - 0.5 * math.pi)))
    label = (_bytes(1, box) + _int(3, o.obj_type)
             + _bytes(4, o.obj_id.encode()))
    if o.difficulty >= 0:
        label += _int(5, o.difficulty)
    if o.num_lidar_points >= 0:
        label += _int(7, o.num_lidar_points)
    obj = (_bytes(1, label) + _float(2, float(o.score))
           + _bytes(4, o.context_name.encode())
           + _int(5, int(o.timestamp_micros)))
    return _bytes(1, obj)


def write_bin(objects: list[WaymoObject], path: str) -> None:
    with open(path, "wb") as f:
        for o in objects:
            f.write(encode_object(o))


def tracklets_to_objects(tracklets: list[dict],
                         class_names=("Car",)) -> list[WaymoObject]:
    """Each tracklet dict: segment_name, id, boxes [T,7] in per-frame EGO
    coords, scores [T], ts [T], and either ``waymo_type`` (the Waymo object
    type id, 1 vehicle / 2 ped / 4 cyclist) or ``type`` (index into
    ``class_names``)."""
    out = []
    for trk in tracklets:
        wtype = (int(trk["waymo_type"]) if "waymo_type" in trk
                 else _CLASS_TO_WAYMO[class_names[trk["type"]]])
        for box, score, ts in zip(trk["boxes"], trk["scores"], trk["ts"]):
            out.append(WaymoObject(tuple(box), float(score), wtype,
                                   trk["id"], trk["segment_name"], int(ts)))
    return out


# ---------------------------------------------------------------- decoding
def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift, v = 0, 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _parse_fields(buf: bytes):
    i = 0
    while i < len(buf):
        k, i = _read_varint(buf, i)
        field, wire = k >> 3, k & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        elif wire == 5:
            v = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v = buf[i:i + n]
            i += n
        else:
            raise ValueError(f"wire type {wire}")
        yield field, v


def read_bin(path: str) -> list[dict]:
    """Round-trip reader for tests: returns dicts with waymo-frame values."""
    with open(path, "rb") as f:
        buf = f.read()
    out = []
    for field, ob in _parse_fields(buf):
        assert field == 1
        rec = {}
        for f2, v2 in _parse_fields(ob):
            if f2 == 1:      # label
                for f3, v3 in _parse_fields(v2):
                    if f3 == 1:
                        rec["box"] = {f4: v4 for f4, v4 in _parse_fields(v3)}
                    elif f3 == 3:
                        rec["type"] = v3
                    elif f3 == 4:
                        rec["id"] = v3.decode()
            elif f2 == 2:
                rec["score"] = v2
            elif f2 == 4:
                rec["context_name"] = v2.decode()
            elif f2 == 5:
                rec["timestamp"] = v2
        out.append(rec)
    return out
