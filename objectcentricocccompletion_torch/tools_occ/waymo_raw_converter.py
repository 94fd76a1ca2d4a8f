"""W0 CLI: Waymo tfrecords -> per-frame raw pkls for the occ annotator (a
copy of the JAX package's ``tools_occ/waymo_raw_converter.py``; the port
imports nothing of that package).

Rebuild of ``Waymo.convert_one`` / the ``waymo_raw`` mode
(``tools/data_converter/waymo_converter.py:549-676``,
``tools/create_data.py:206-236``): for each frame and each of the 5 LiDARs,
write ``{name}_BEAM_INCLINATION`` [H], ``{name}_LIDAR_EXTRINSIC`` [4, 4] and
``{name}_RANGE_IMAGE_MERGE_VIRTUAL`` [H, W] (min-range merge of both
returns, built with ``range_image.build_virtual_range_image``) into
``<out>/<file_idx>.pkl``.

It is self-contained — no tensorflow or waymo_open_dataset imports:
  * TFRecord framing is 20 bytes of header/footer around each record
    (uint64 length + masked-crc32; crcs are not verified here),
  * the ``Frame`` proto subset (context.laser_calibrations and each laser's
    zlib-compressed range images) is parsed straight off the wire with the
    same hand-rolled reader style as ``evalx/waymo_bin.py``. Field numbers
    mirror the public waymo-open-dataset ``dataset.proto``.

Rolling-shutter pose correction matches the official converter: the TOP
lidar's ``range_image_pose_compressed`` (per-pixel world pose) rebuilds
each column's points at its true capture pose and maps them back through
the frame pose (``range_image.range_image_to_points`` with
``pixel_pose``/``frame_pose``). The synthetic-fixture round trip in
``tests/test_waymo_raw_converter.py`` pins the full pipeline.
"""
from __future__ import annotations

import argparse
import os
import pickle
import struct
import zlib

import numpy as np

from .range_image import build_virtual_range_image, range_image_to_points

LIDAR_IDS = {1: "TOP", 2: "FRONT", 3: "SIDE_LEFT", 4: "SIDE_RIGHT",
             5: "REAR"}


# ------------------------------------------------------------ tfrecords
def read_tfrecord(path: str):
    """Yield raw record payloads from a TFRecord file (crc unverified)."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if len(head) < 12:
                return
            (length,) = struct.unpack("<Q", head[:8])
            data = f.read(length)
            f.read(4)   # data crc
            if len(data) < length:
                return
            yield data


def write_tfrecord(path: str, records) -> None:
    """Minimal TFRecord writer (zero crcs) for fixtures/tests."""
    with open(path, "wb") as f:
        for rec in records:
            f.write(struct.pack("<Q", len(rec)) + b"\0" * 4)
            f.write(rec)
            f.write(b"\0" * 4)


# ------------------------------------------------------- proto parsing
class _Cur:
    __slots__ = ("b", "i", "end")

    def __init__(self, b, i=0, end=None):
        self.b = b
        self.i = i
        self.end = len(b) if end is None else end


def _varint(c: _Cur) -> int:
    v = 0
    shift = 0
    while c.i < c.end:
        byte = c.b[c.i]
        c.i += 1
        v |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return v


def _fields(buf: bytes):
    """Yield (field, wire, value) — value is bytes for wire 2, int for
    wire 0, raw 8/4 bytes for wires 1/5."""
    c = _Cur(buf)
    while c.i < c.end:
        key = _varint(c)
        field, wire = key >> 3, key & 7
        if wire == 0:
            yield field, wire, _varint(c)
        elif wire == 1:
            yield field, wire, c.b[c.i:c.i + 8]
            c.i += 8
        elif wire == 5:
            yield field, wire, c.b[c.i:c.i + 4]
            c.i += 4
        elif wire == 2:
            n = _varint(c)
            yield field, wire, c.b[c.i:c.i + n]
            c.i += n
        else:
            return


def _packed_doubles(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf, "<f8")


def _parse_matrix_float(buf: bytes) -> np.ndarray:
    """MatrixFloat { repeated float data = 1 [packed]; MatrixShape shape =
    2 { repeated int32 dims = 1 } } -> ndarray."""
    data = np.zeros((0,), np.float32)
    dims = []
    for field, wire, v in _fields(buf):
        if field == 1 and wire == 2:
            data = np.frombuffer(v, "<f4")
        elif field == 2 and wire == 2:
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:       # packed varint dims
                    c = _Cur(v2)
                    while c.i < c.end:
                        dims.append(_varint(c))
                elif f2 == 1 and w2 == 0:     # unpacked dim
                    dims.append(int(v2))
    return data.reshape(dims) if dims else data


def _parse_calibration(buf: bytes) -> dict:
    """LaserCalibration { name = 1; beam_inclinations = 2;
    beam_inclination_min = 3; beam_inclination_max = 4; extrinsic = 5 }."""
    out = dict(name=0, inclinations=None, incl_min=0.0, incl_max=0.0,
               extrinsic=np.eye(4))
    incl = []
    for field, wire, v in _fields(buf):
        if field == 1 and wire == 0:
            out["name"] = int(v)
        elif field == 2 and wire == 2:            # packed doubles
            incl.extend(_packed_doubles(v).tolist())
        elif field == 2 and wire == 1:            # unpacked double
            incl.append(struct.unpack("<d", v)[0])
        elif field == 3 and wire == 1:
            out["incl_min"] = struct.unpack("<d", v)[0]
        elif field == 4 and wire == 1:
            out["incl_max"] = struct.unpack("<d", v)[0]
        elif field == 5 and wire == 2:            # Transform
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:
                    out["extrinsic"] = _packed_doubles(v2).reshape(4, 4)
    if incl:
        out["inclinations"] = np.asarray(incl)
    return out


def _parse_range_image(buf: bytes
                       ) -> tuple[np.ndarray | None, np.ndarray | None]:
    """RangeImage { range_image_compressed = 2;
    range_image_pose_compressed = 4 (both zlib MatrixFloat) } ->
    ([H, W, C] channel 0 = range, [H, W, 6] per-pixel pose or None).
    The pose image exists only on the TOP lidar's first return."""
    ri = pose = None
    for field, wire, v in _fields(buf):
        if field == 2 and wire == 2:
            ri = _parse_matrix_float(zlib.decompress(v))
        elif field == 4 and wire == 2:
            pose = _parse_matrix_float(zlib.decompress(v))
    return ri, pose


def parse_frame(buf: bytes) -> dict:
    """Frame { context = 1 { laser_calibrations = 3 }; timestamp = 2;
    pose = 3 (Transform); lasers = 5 { name = 1; ri_return1 = 2;
    ri_return2 = 3 } }."""
    cals = {}
    lasers = {}
    ts = 0
    pose = None
    pixel_pose = None
    for field, wire, v in _fields(buf):
        if field == 1 and wire == 2:
            for f2, w2, v2 in _fields(v):
                if f2 == 3 and w2 == 2:
                    cal = _parse_calibration(v2)
                    cals[cal["name"]] = cal
        elif field == 2 and wire == 0:
            ts = int(v)
        elif field == 3 and wire == 2:            # frame pose Transform
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:
                    pose = _packed_doubles(v2).reshape(4, 4)
        elif field == 5 and wire == 2:
            name = 0
            ri1 = ri2 = None
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 0:
                    name = int(v2)
                elif f2 == 2 and w2 == 2:
                    ri1, pp = _parse_range_image(v2)
                    if pp is not None:
                        pixel_pose = pp
                elif f2 == 3 and w2 == 2:
                    ri2, _ = _parse_range_image(v2)
            lasers[name] = (ri1, ri2)
    return dict(calibrations=cals, lasers=lasers, timestamp=ts,
                pose=pose, top_pixel_pose=pixel_pose)


# ------------------------------------------------------------ conversion
def frame_to_raw(frame: dict) -> dict:
    """One parsed frame -> the annotator's raw dict (virtual range images
    merged over both returns)."""
    out = {}
    for lid, name in LIDAR_IDS.items():
        cal = frame["calibrations"].get(lid)
        ris = frame["lasers"].get(lid)
        if cal is None or ris is None:
            continue
        ri1 = ris[0]
        H = ri1.shape[0] if ri1 is not None else 64
        if cal["inclinations"] is not None:
            incl = np.asarray(cal["inclinations"])
        else:
            incl = np.linspace(cal["incl_min"], cal["incl_max"], H)
        extrinsic = np.asarray(cal["extrinsic"])
        # rows are stored top-beam-first (descending inclination)
        incl_desc = np.flip(np.sort(incl))
        out[f"{name}_LIDAR_EXTRINSIC"] = extrinsic
        # the annotator's convention (tools_occ/annotate._visibility):
        # BEAM_INCLINATION stored DESCENDING, virtual range image rows in
        # ASCENDING beam order (it flips the inclinations on read)
        out[f"{name}_BEAM_INCLINATION"] = incl_desc.astype(np.float32)
        # rolling-shutter correction: the TOP lidar's per-pixel pose image
        # rebuilds each column's points at its true capture pose
        # (waymo_converter.py:660-670)
        pixel_pose = (frame.get("top_pixel_pose")
                      if name == "TOP" else None)
        frame_pose = frame.get("pose")
        pts = []
        width = None
        for ri in ris:
            if ri is None or ri.size == 0:
                continue
            rng = ri[..., 0] if ri.ndim == 3 else ri
            width = rng.shape[1]
            pp = (pixel_pose if pixel_pose is not None
                  and pixel_pose.shape[:2] == rng.shape else None)
            pts.append(range_image_to_points(rng, extrinsic, incl_desc,
                                             pp, frame_pose))
        if not pts or width is None:
            continue
        pts_ego = np.concatenate(pts, 0)
        out[f"{name}_RANGE_IMAGE_MERGE_VIRTUAL"] = \
            build_virtual_range_image(
                pts_ego[:, :3], extrinsic, incl_desc, width)[::-1]
    return out


def convert_segment(tfrecord_path: str, out_dir: str, file_idx_base: str
                    ) -> int:
    """tfrecord -> per-frame raw pkls; returns the number of frames."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for frame_idx, data in enumerate(read_tfrecord(tfrecord_path)):
        frame = parse_frame(data)
        out = frame_to_raw(frame)
        with open(os.path.join(out_dir,
                               f"{file_idx_base}{frame_idx:03d}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)
        n += 1
    return n


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tfrecord-dir", required=True)
    p.add_argument("--out-dir", required=True)
    args = p.parse_args()
    records = sorted(f for f in os.listdir(args.tfrecord_dir)
                     if "tfrecord" in f)
    for i, r in enumerate(records):
        convert_segment(os.path.join(args.tfrecord_dir, r), args.out_dir,
                        f"{i:04d}")


if __name__ == "__main__":
    main()
