"""The port's host-side evaluation pieces held against the JAX package on
the CPU: the Waymo ``.bin`` bytes and their reader, the submission
shards, the native metrics binary that the port builds into ``build/``
and the parse of its output, the occupancy accumulator, grids and
baseline, the length buckets, and the evaluation CLIs (``tools/test.py``
on checkpoints of the port's ``tools/train.py``;
``tools/create_submission.py``).
Nothing here compiles a JAX model; bars: bytes and integers exact, floats
within 1e-6."""
import json
import math
import os
import pickle

import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.configs import ococcnet_config as jcfgm
from objectcentricocccompletion_tpu.evalx import evaluator as jev
from objectcentricocccompletion_tpu.evalx import occ_iou as jocc
from objectcentricocccompletion_tpu.evalx import submission as jsub
from objectcentricocccompletion_tpu.evalx import waymo_bin as jwb
from objectcentricocccompletion_tpu.evalx import waymo_metrics as jwm
from objectcentricocccompletion_torch.configs import ococcnet_config as tcfgm
from objectcentricocccompletion_torch.data.frame_dataset import (
    write_synthetic_frames)
from objectcentricocccompletion_torch.data.loader import (
    write_synthetic_dataset)
from objectcentricocccompletion_torch.data.frame_dataset import FrameDataset
from objectcentricocccompletion_torch.evalx import detector_eval as tdet
from objectcentricocccompletion_torch.evalx import evaluator as tev
from objectcentricocccompletion_torch.evalx import occ_iou as tocc
from objectcentricocccompletion_torch.evalx import submission as tsub
from objectcentricocccompletion_torch.evalx import waymo_bin as twb
from objectcentricocccompletion_torch.evalx import waymo_metrics as twm
from objectcentricocccompletion_torch.tools import create_submission as tcs
from objectcentricocccompletion_torch.tools import test as tcli
from objectcentricocccompletion_torch.tools import train as ttrain
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def _objects(mod, seed=0, n=12):
    """Random objects of three tracks, with and without the GT extras."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        box = tuple(rng.uniform(-30, 30, 3).tolist()
                    + rng.uniform(0.5, 5, 3).tolist()
                    + [rng.uniform(-2 * math.pi, 2 * math.pi)])
        extra = (dict(num_lidar_points=int(rng.randint(0, 300)),
                      difficulty=int(rng.randint(1, 3))) if i % 2 else {})
        out.append(mod.WaymoObject(
            box, float(rng.rand()), int(rng.choice([1, 2, 4])),
            f"trk_{i % 3}", f"segment-{i % 2}",
            int(1_500_000_000_000_000 + 100_000 * i), **extra))
    return out


def test_waymo_bin_bytes_equal_the_jax_package(tmp_path):
    for a, b in zip(_objects(twb), _objects(jwb)):
        assert twb.encode_object(a) == jwb.encode_object(b)
    twb.write_bin(_objects(twb), str(tmp_path / "t.bin"))
    jwb.write_bin(_objects(jwb), str(tmp_path / "j.bin"))
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    back = twb.read_bin(str(tmp_path / "t.bin"))
    assert back == jwb.read_bin(str(tmp_path / "j.bin"))
    for rec, o in zip(back, _objects(twb)):
        cx, cy, cz, w, l, h, yaw = o.box
        assert [rec["box"][k] for k in range(1, 7)] == \
            [cx, cy, cz + h / 2, w, l, h]
        assert rec["box"][7] == twb.wrap_heading(-yaw - 0.5 * math.pi)
        assert -math.pi <= rec["box"][7] <= math.pi
        assert (rec["id"], rec["type"], rec["context_name"],
                rec["timestamp"]) == (o.obj_id, o.obj_type, o.context_name,
                                      o.timestamp_micros)
        assert rec["score"] == np.float32(o.score)
    trk = [dict(segment_name="s", id="a", type=0,
                boxes=np.ones((3, 7), np.float32), scores=[0.1, 0.2, 0.3],
                ts=[1, 2, 3]),
           dict(segment_name="s", id="b", waymo_type=4,
                boxes=np.zeros((2, 7)), scores=[0.5, 0.6], ts=[1, 2])]
    got = [twb.encode_object(o)
           for o in twb.tracklets_to_objects(trk, ("Car",))]
    assert got == [jwb.encode_object(o)
                   for o in jwb.tracklets_to_objects(trk, ("Car",))]
    assert len(got) == 5


def test_submission_shards_equal_the_jax_package(tmp_path):
    twb.write_bin(_objects(twb, n=9), str(tmp_path / "r.bin"))
    kw = dict(unique_method_name="m", account_name="a@b", authors=["x", "y"],
              affiliation="lab", latency_second=0.25)
    tp = tsub.create_submission(str(tmp_path / "r.bin"), str(tmp_path / "t"),
                                "sub", tsub.SubmissionMeta(**kw),
                                num_shards=4, tar=False)
    jp = jsub.create_submission(str(tmp_path / "r.bin"), str(tmp_path / "j"),
                                "sub", jsub.SubmissionMeta(**kw),
                                num_shards=4, tar=False)
    assert len(tp) == len(jp) == 4
    for a, b in zip(tp, jp):
        assert open(a, "rb").read() == open(b, "rb").read()
    dec = tsub.read_submission(tp[0])
    assert dec["object_types"] == [1, 2, 4]
    assert dec["unique_method_name"] == "m" and dec["authors"] == ["x", "y"]
    payload = b"".join(tsub.read_submission(p)["objects_payload"]
                       for p in tp)
    assert payload == (tmp_path / "r.bin").read_bytes()

    # the CLI, with --remove-empty through kitti-format infos
    root = str(tmp_path / "frames")
    infos = write_synthetic_frames(root, num_frames=2, num_points=3000,
                                   num_boxes=4)
    with open(infos, "rb") as f:
        info = pickle.load(f)[0]
    objs = [twb.WaymoObject((0.0, 0.0, -2.0, 300.0, 300.0, 5.0, 0.0), 0.9,
                            1, "full", "synth-seg", info["timestamp"]),
            twb.WaymoObject((500.0, 500.0, 0.0, 1.0, 1.0, 1.0, 0.0), 0.8,
                            1, "empty", "synth-seg", info["timestamp"])]
    twb.write_bin(objs, str(tmp_path / "p.bin"))
    paths = tcs.main([str(tmp_path / "p.bin"), "--out-dir",
                      str(tmp_path / "cli"), "--method-name", "m",
                      "--num-shards", "2", "--remove-empty", "--infos",
                      infos, "--data-root", root])
    assert [os.path.basename(p) for p in paths] == \
        ["submission0", "submission1", "submission.tar.gz"]
    kept = twb.read_bin(str(tmp_path / "cli" / "nonempty_p.bin"))
    assert [r["id"] for r in kept] == ["full"]


def test_native_metrics_build_and_parse(tmp_path, monkeypatch):
    """The binary builds from the shared source into ``build/`` under a
    digest name (never under ``native/``), and its output parses as the
    JAX wrapper parses it."""
    path = twm.ensure_built()
    assert os.path.dirname(path) == str(twm.BUILD_DIR)
    assert os.path.basename(path).startswith(
        "compute_detection_metrics_main-")
    assert twm.ensure_built() == path
    rng = np.random.RandomState(3)
    gt, pred = [], []
    for i in range(20):
        box = rng.uniform(-20, 20, 7) * [1, 1, 0.05, 0, 0, 0, 0.1] \
            + [0, 0, 0, 2, 4.5, 1.6, 0]
        gt.append(twb.WaymoObject(tuple(box), 1.0, 1, f"g{i}", "seg",
                                  i // 4, num_lidar_points=20,
                                  difficulty=1))
        pred.append(twb.WaymoObject(tuple(box + rng.normal(0, 0.05, 7)),
                                    float(rng.rand()), 1, f"p{i}", "seg",
                                    i // 4))
    twb.write_bin(pred, str(tmp_path / "pred.bin"))
    twb.write_bin(gt, str(tmp_path / "gt.bin"))
    got = twm.compute_metrics(str(tmp_path / "pred.bin"),
                              str(tmp_path / "gt.bin"))
    monkeypatch.setattr(jwm, "ensure_built", lambda: path)
    ref = jwm.compute_metrics(str(tmp_path / "pred.bin"),
                              str(tmp_path / "gt.bin"))
    assert got == ref
    assert 0.5 < got["OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/mAP"] <= 1.0


def test_occ_host_pieces_equal_the_jax_package(tmp_path):
    rng = np.random.RandomState(0)
    # the accumulator, at 1e-6
    ta, ja = tocc.OccIoUAccumulator(), jocc.OccIoUAccumulator()
    for _ in range(5):
        L = int(rng.randint(1, 9))
        union = rng.randint(0, 50, L)
        inter = (union * rng.rand(L)).astype(np.int64)
        vols = rng.uniform(1, 300, L)
        valid = rng.rand(L) < 0.8
        ta.add_tracklet(inter, union, vols, valid)
        ja.add_tracklet(inter, union, vols, valid)
    for prefix in ("occ", "occ_baseline"):
        got, ref = ta.summary(prefix), ja.summary(prefix)
        assert got.keys() == ref.keys()
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-6, k
    assert len(got) == 6
    # the grids and the query buffer, exact
    for size in ([4.3, 1.9, 1.55], [0.1, 0.1, 0.1], [2.0, 1.0, 1.0]):
        np.testing.assert_array_equal(tocc.dense_voxel_centers(size, 0.2),
                                      jocc.dense_voxel_centers(size, 0.2))
    occ = rng.choice([0, 1, 2], (9, 7, 5), p=[0.3, 0.3, 0.4])
    np.savez(tmp_path / "o.npz", occ=occ)
    for kmax in (512, 64):
        for a, b in zip(tocc.load_full_occ_queries(str(tmp_path / "o.npz"),
                                                   0.2, kmax),
                        jocc.load_full_occ_queries(str(tmp_path / "o.npz"),
                                                   0.2, kmax)):
            np.testing.assert_array_equal(a, b)
    # the point-aggregation baseline, exact
    L, P, K = 6, 80, 300
    size = np.array([3.0, 1.6, 1.4])
    rois = np.concatenate([rng.uniform(-2, 2, (L, 3)), np.tile(size, (L, 1))
                           * rng.uniform(0.9, 1.1, (L, 3)),
                           rng.uniform(-0.3, 0.3, (L, 1))], -1)
    gt = rois + rng.normal(0, 0.1, (L, 7))
    pts = rois[:, None, :3] + rng.uniform(-1, 1, (L, P, 3)) * size / 2
    pts[..., 2] += size[2] / 2
    mask = rng.rand(L, P) < 0.7
    qp = rng.uniform(-0.5, 0.5, (K, 3)) * size
    lab = rng.randint(0, 2, K)
    qm = rng.rand(K) < 0.9
    valid = rng.rand(L) < 0.8
    for a, b in zip(
            tocc.occ_baseline_tracklet(pts, mask, rois, gt, valid, qp, lab,
                                       qm, 0.2),
            jocc.occ_baseline_tracklet(pts, mask, rois, gt, valid, qp, lab,
                                       qm, 0.2)):
        np.testing.assert_array_equal(a, b)
        assert a.sum() > 0


def test_pad_to_bucket_equals_the_jax_package():
    rng = np.random.RandomState(1)
    cfg_t, cfg_j = tcfgm.tiny_config(), jcfgm.tiny_config()
    assert tev.LENGTH_BUCKETS == jev.LENGTH_BUCKETS
    assert tev.MAX_OCC_QUERIES == jev.MAX_OCC_QUERIES
    for T in (1, 32, 33, 200, 256, 300):
        s = dict(points=rng.rand(T, 4, 10).astype(np.float32),
                 points_mask=rng.rand(T, 4) < 0.5,
                 rois=rng.rand(T, 7).astype(np.float32),
                 roi_scores=rng.rand(T).astype(np.float32),
                 gt_boxes=rng.rand(T, 7).astype(np.float32),
                 gt_valid=rng.rand(T) < 0.5,
                 frame_inds=np.arange(T, dtype=np.int32) + 3,
                 occ_score=np.float32(0.7))
        got, tt = tev.pad_to_bucket(s, cfg_t)
        ref, tj = jev.pad_to_bucket(s, cfg_j)
        assert tt == tj == T
        assert got.keys() == ref.keys()
        for k in ref:
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got["rois"].shape[0] == {1: 32, 32: 32, 33: 64, 200: 256,
                                        256: 256, 300: 320}[T]


@pytest.fixture(scope="module")
def tracklets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_cli"))
    paths = write_synthetic_dataset(os.path.join(root, "ds"),
                                    num_tracklets=3, track_len=12, seed=3)
    flags = ["--proposals", paths["proposals_file"], "--gt-candidates",
             paths["gt_candidates_file"], "--poses", paths["pose_file"],
             "--occ-root", paths["occ_anno_root"]]
    ckpts = {}
    for model in ("ococcnet", "ctrl"):
        work = os.path.join(root, model)
        ttrain.main([model, *flags, "--tiny", "--device", "cpu",
                     "--total-steps", "2", "--work-dir", work])
        ckpts[model] = os.path.join(work, "ckpt")
    return root, flags, ckpts


@pytest.mark.parametrize("model", ["ococcnet", "ctrl"])
def test_cli_evaluates_a_checkpoint_of_the_train_cli(tracklets, model,
                                                     capsys):
    """``tools/test.py`` restores the train CLI's checkpoint, writes one
    Waymo object per frame, scores them with the native binary and (for
    OcOccNet) the occupancy IoU, and prints the metrics."""
    root, flags, ckpts = tracklets
    out = os.path.join(root, f"eval_{model}")
    extra = ["--occ-baseline", "--tta", "--tune-steps", "2"] \
        if model == "ococcnet" else []
    metrics = tcli.main([model, *flags, "--tiny", "--device", "cpu",
                         "--ckpt-dir", ckpts[model], "--out-dir", out,
                         *extra])
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == json.loads(
        json.dumps(metrics, default=float))
    assert metrics["num_tracklets"] == 3
    recs = twb.read_bin(metrics["results_bin"])
    assert len(recs) == 3 * 12
    assert len({(r["id"], r["timestamp"]) for r in recs}) == len(recs)
    assert len(twb.read_bin(os.path.join(out, "gt.bin"))) == 3 * 12
    assert "OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/mAP" in metrics
    occ = {k: v for k, v in metrics.items() if k.startswith("occ")}
    if model == "ctrl":
        assert not occ
    else:
        assert "occ/overall_iou" in occ and "occ_baseline/miou_box" in occ
        assert all(0.0 <= v <= 1.0 for v in occ.values())


def test_cli_refuses_what_is_not_ported(tracklets, tmp_path):
    _, flags, ckpts = tracklets
    # votenet and the other datasets are ported: what stays refused is a
    # call without its inputs, the Waymo metric on another dataset and an
    # empty checkpoint directory (an empty Argoverse 2 split reads)
    with pytest.raises(SystemExit, match="needs --infos"):
        tcli.main(["votenet", "--ckpt-dir", str(tmp_path), "--device",
                   "cpu"])
    frame = ["sst", "--ckpt-dir", str(tmp_path), "--device", "cpu",
             "--infos", "x.pkl", "--data-root", "."]
    with pytest.raises(SystemExit, match="metric waymo"):
        tcli.main([*frame, "--dataset", "nuscenes", "--metric", "waymo"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        tcli.main([*frame, "--dataset", "argo2", "--tiny"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        tcli.main(["ococcnet", *flags, "--tiny", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path / "empty")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(["ococcnet", *flags, "--tiny", "--ckpt-dir",
                       ckpts["ococcnet"]])


def test_detector_metrics_on_oracle_predictions(tmp_path):
    """The GT boxes echoed as predictions through ``evaluate_detector``
    (score filter, per-class NMS, annos difficulty, KITTI AP) give AP 1 at
    every difficulty, boxes moved by 5 m give 0; through
    ``evaluate_detector_waymo`` (the .bin files and the native binary)
    the vehicle mAP is the protocol's cap for N ground truths, min(1,
    0.05 N)."""
    root = str(tmp_path / "frames")
    infos = write_synthetic_frames(root, num_frames=3, num_points=3000,
                                   num_boxes=6, classes=("Car",))
    ds = FrameDataset(infos, root, max_points=4096, max_gt=32)
    seen = []

    def oracle(shift=0.0):
        def fn(points, mask):
            s = ds.build_sample(len(seen) % len(ds),
                                np.random.RandomState(0))
            seen.append(1)
            n = int(s["gt_valid"].sum())
            boxes = s["gt_boxes"][:n].copy()
            boxes[:, :2] += shift
            # distinct scores: the Waymo protocol samples score cutoffs
            return (boxes, 0.9 - 0.01 * np.arange(n), s["gt_labels"][:n],
                    np.ones(n, bool))
        return fn

    ap = tdet.evaluate_detector(None, "sst", ds, predict_fn=oracle())
    assert ap == pytest.approx(
        {f"Car_3d_{d}": 1.0 for d in ("easy", "moderate", "hard")}, abs=1e-9)
    seen.clear()
    ap = tdet.evaluate_detector(None, "sst", ds, predict_fn=oracle(5.0))
    assert set(ap.values()) == {0.0}
    seen.clear()
    out = tdet.evaluate_detector_waymo(None, "sst", ds,
                                       str(tmp_path / "eval"),
                                       predict_fn=oracle())
    veh = {k: v for k, v in out.items()
           if k.startswith("OBJECT_TYPE_TYPE_VEHICLE")}
    assert len(veh) == 4
    for k, v in veh.items():
        assert v == pytest.approx(min(1.0, 0.05 * 6), abs=1e-5), k
