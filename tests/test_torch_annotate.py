"""The W1 occupancy annotator of the port against the JAX package on the
CPU: ``_range_image_visibility`` against the jitted JAX function on seeded
scenes (random rigid extrinsics and beams, and one scene built on the
boundaries: a nearest-beam tie, a column at exactly .5 and a range equal
to ``ri_val``), ``OccAnnotator``'s npz against the JAX annotator's on
``tests/test_annotate.py``'s scenes, the four functions of
``range_image.py``, and the margin rule itself.

Bars: every answer equal, or, where two runs differ, a difference that the
margin rule allows (``annotate.unexplained``: a decision within 4 float32
ulps of its boundary in a frame that decides the any); the npz arrays equal
byte for byte; ``range_image`` equal.
"""
import os

import numpy as np
import torch

from objectcentricocccompletion_tpu.tools_occ import annotate as jann
from objectcentricocccompletion_tpu.tools_occ import range_image as jri
from objectcentricocccompletion_torch.tools_occ import annotate as tann
from objectcentricocccompletion_torch.tools_occ import range_image as tri
from tests.test_annotate import make_scene
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

T, N, H, W = 5, 300, 32, 256


def random_scene(seed):
    """One sensor over T frames: boxes 10-30 m out, rigid extrinsics (yaw,
    a small pitch, a lever arm), sorted random beams, ranges 2-24 m."""
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([
        rng.uniform(10, 30, (T, 1)) * np.array([[1.0, 0.5]]),
        rng.uniform(-1.5, -0.5, (T, 1)), np.tile([[4.5, 2.0, 1.8]], (T, 1)),
        rng.uniform(-np.pi, np.pi, (T, 1))], -1)
    centers = rng.uniform([-2.2, -1.0, 0.0], [2.2, 1.0, 1.8], (N, 3))
    extr = np.tile(np.eye(4), (T, 1, 1))
    for t in range(T):
        yaw, pitch = rng.uniform(-np.pi, np.pi), rng.uniform(-0.05, 0.05)
        cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), \
            np.sin(pitch)
        extr[t, :3, :3] = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]) @ \
            np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        extr[t, :3, 3] = rng.uniform([-1, -0.5, 1.5], [1.5, 0.5, 2.2])
    incl = np.sort(rng.uniform(-0.4, 0.1, (T, H)), -1)
    ri = rng.uniform(2, 24, (T, H, W))
    return [a.astype(np.float32) for a in (centers, boxes, extr, incl, ri)]


def boundary_scene():
    """One frame, identity extrinsic, a yaw-0 box at x = 10: voxel A sits
    on the sensor's x axis (azimuth 0: column W/2 - 0.5 exactly, which
    rounds half to even), B's inclination equals two beams (a tie: the
    first wins) and C's range equals its cell's value (``>=``: visible).
    Every other cell reads 1 m, so each voxel is free only through the
    decision it tests."""
    box = np.array([[10.0, 0.0, -1.0, 4.0, 2.0, 2.0, 0.0]], np.float32)
    centers = np.array([[-1.9, 0.0, 1.0], [-1.5, 0.3, 1.5],
                        [-1.0, -0.4, 0.5]], np.float32)
    extr = np.eye(4, dtype=np.float32)[None]
    incl = np.linspace(-0.3, 0.3, 64).astype(np.float32)[None]
    ri = np.ones((1, 64, 2650), np.float32)
    # the port's float32 sensor-frame quantities on the CPU
    _, (px, py, pz) = tann._sensor_points(
        *(torch.from_numpy(a) for a in (centers, box, extr)))
    elev = torch.atan2(pz, torch.sqrt(px * px + py * py))[0].numpy()
    rng32 = torch.sqrt(px * px + py * py + pz * pz)[0].numpy()
    az = np.arctan2(py[0].numpy(), px[0].numpy()).astype(np.float64)
    col = np.mod(np.round(2650 - 0.5 - (az + np.pi) / (2 * np.pi) * 2650),
                 2650).astype(int)
    row = np.abs(elev[:, None] - incl[0][None]).argmin(-1)
    assert col[0] == 1324                     # 1324.5, rounded half to even
    ri[0, row[0], 1324] = 100.0
    b = row[1]
    incl[0, b] = incl[0, b + 1] = elev[1]     # an exact tie
    ri[0, b, col[1]] = 100.0
    ri[0, row[2], col[2]] = rng32[2]
    return centers, box, extr, incl, ri


def jax_visibility(centers, boxes, extr, incl, ri):
    return np.asarray(jann._range_image_visibility(
        centers, boxes, extr, incl, ri, ri.shape[-1]))


def port_visibility(centers, boxes, extr, incl, ri):
    return tann._range_image_visibility(
        *(torch.from_numpy(a) for a in (centers, boxes, extr, incl,
                                        ri))).numpy()


def test_visibility_equals_the_jax_function_within_the_margins():
    scenes = [random_scene(s) for s in range(3)] + [boundary_scene()]
    total = 0
    for k, scene in enumerate(scenes):
        j, t = jax_visibility(*scene), port_visibility(*scene)
        assert t.dtype == np.int32 and t.shape == j.shape
        bad = tann.unexplained(j, t, [tann.decision_margins(*scene)])
        assert not bad.any(), (k, np.nonzero(bad))
        total += int((j != t).sum())
        assert 0.1 < (t == 2).mean() < 0.9 or k == 3
    # the boundary scene: half to even, the first of tied beams, >=
    np.testing.assert_array_equal(port_visibility(*scenes[3]), [2, 2, 2])
    assert total <= 3, total


def test_annotator_npz_equals_the_jax_annotator(tmp_path):
    """See-through, blocked, short track, idempotent, save_mean_var:
    every npz array byte for byte, and the same paths returned."""
    boxes, ts_list, get_points, get_raw_frame = make_scene()

    def fill(value):
        def frame(ts):
            f = dict(get_raw_frame(ts))
            f["TOP_RANGE_IMAGE_MERGE_VIRTUAL"] = np.full((64, 2650), value,
                                                         np.float32)
            return f
        return frame

    cases = [("far", fill(100.0), {}), ("near", fill(7.0), {}),
             ("short", get_raw_frame, {"min_track_len": 100}),
             ("plain", get_raw_frame, {}),
             ("mv", get_raw_frame, {"save_mean_var": True})]
    for name, raw, kw in cases:
        outs = []
        for pkg, ann_cls, extra in (("jax", jann.OccAnnotator, {}),
                                    ("port", tann.OccAnnotator,
                                     {"device": "cpu"})):
            root = str(tmp_path / pkg)
            ann = ann_cls(get_points, raw, root, voxel_size=0.2,
                          lidar_names=("TOP",), **kw, **extra)
            p1 = ann.annotate_trk(f"seg-{name}", "trk-1", boxes, ts_list)
            # idempotent: a second call returns the cached file
            p2 = ann.annotate_trk(f"seg-{name}", "trk-1", boxes, ts_list)
            assert p1 == p2
            outs.append(None if p1 is None else
                        (os.path.relpath(p1, root), dict(np.load(p1))))
        if name == "short":
            assert outs == [None, None]
            continue
        (jp, ja), (tp, ta) = outs
        assert jp == tp and sorted(ja) == sorted(ta)
        for key in ja:
            assert ja[key].dtype == ta[key].dtype, key
            assert ja[key].shape == ta[key].shape, key
            assert ja[key].tobytes() == ta[key].tobytes(), (name, key)
        assert set(np.unique(ta["occ"])) <= {0, 1, 2}


def test_range_image_equals_the_jax_package():
    rng = np.random.RandomState(0)
    ext = np.eye(4)
    ext[:3, :3] = [[0.96, -0.28, 0.0], [0.28, 0.96, 0.0], [0.0, 0.0, 1.0]]
    ext[:3, 3] = [1.2, -0.3, 2.1]
    incl = np.linspace(-0.4, 0.3, 48)
    pts = np.concatenate([rng.uniform(-30, 30, (2000, 2)),
                          rng.uniform(-2, 3, (2000, 1))], -1)
    for a, b in zip(jri.project_to_range_image(pts, ext, incl, 640),
                    tri.project_to_range_image(pts, ext, incl, 640)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        jri.build_virtual_range_image(pts, ext, incl, 640, fill=-1.0),
        tri.build_virtual_range_image(pts, ext, incl, 640, fill=-1.0))
    pose6 = rng.uniform(-0.2, 0.2, (50, 6))
    for a, b in zip(jri.rollpitchyaw_to_matrices(pose6),
                    tri.rollpitchyaw_to_matrices(pose6)):
        np.testing.assert_array_equal(a, b)
    ri = tri.build_virtual_range_image(pts, ext, incl, 640)
    pixel_pose = np.zeros((48, 640, 6))
    pixel_pose[:, ::2] = rng.uniform(-0.1, 0.1, (48, 320, 6))
    frame_pose = np.eye(4)
    frame_pose[:3, 3] = [3.0, -1.0, 0.2]
    for args in ((ri, ext, np.flip(incl)),
                 (ri, ext, np.flip(incl), pixel_pose, frame_pose)):
        np.testing.assert_array_equal(jri.range_image_to_points(*args),
                                      tri.range_image_to_points(*args))


def test_the_margin_rule_catches_a_flip_away_from_the_boundaries():
    """The rule is not vacuous: flipping a voxel that some frame sees
    through away from every boundary (or one that no decision lies near)
    is unexplained; two equal grids differ nowhere; a changed occupied
    voxel counts against them."""
    scene = random_scene(0)
    vis = port_visibility(*scene)
    visible, near = tann.decision_margins(*scene)
    confident = (visible & ~near).any(0)
    flipped = vis.copy()
    k = int(np.nonzero(confident)[0][0])
    flipped[k] = 2 - flipped[k]
    assert tann.unexplained(vis, flipped, [(visible, near)])[k]
    quiet = np.nonzero(~near.any(0) & ~visible.any(0))[0]
    flipped = vis.copy()
    flipped[quiet] = 2
    assert tann.unexplained(vis, flipped, [(visible, near)])[quiet].all()
    assert near.mean() < 0.05

    boxes, ts_list, get_points, get_raw_frame = make_scene()
    frames = [get_raw_frame(ts) for ts in ts_list]
    occ = np.zeros((20, 10, 10), np.int32)
    occ[0] = 1
    occ[5:] = 2
    same = tann.grid_differences(occ, occ.copy(), boxes, frames, 0.2,
                                 ("TOP",))
    assert same == {"differ": 0, "occupied_differ": 0, "unexplained": 0}
    other = occ.copy()
    other[0, 0, 0] = 2           # an occupied voxel
    other[10, 5, 5] = 0          # free behind the face (8.1 m): far past it
    diff = tann.grid_differences(occ, other, boxes, frames, 0.2, ("TOP",))
    assert diff == {"differ": 2, "occupied_differ": 1, "unexplained": 2}
