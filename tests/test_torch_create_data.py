"""The port's data-prep side against the JAX package on the CPU:
``waymo_raw_converter`` on ``tests/test_waymo_raw_converter.py``'s
synthetic records, ``generate_tracklets`` and ``extend_tracks`` on
``tests/test_tools_ctrl.py``'s bins, and the port's ``tools/create_data.py``
(``occ_annotate``, ``tracklets``, ``fsdpp_seeds``, called in process)
against the JAX repository's CLI functions on the same files.

Bars: every output equal (pkl contents, npy and npz arrays byte for byte,
the ``.bin`` bytes).
"""
import argparse
import dataclasses
import importlib.util
import os
import pickle

import numpy as np

from objectcentricocccompletion_tpu.data import seed_store as jss
from objectcentricocccompletion_tpu.tools_ctrl import extend_tracks as jext
from objectcentricocccompletion_tpu.tools_ctrl import generate_tracklets as jgt
from objectcentricocccompletion_tpu.tools_occ import waymo_raw_converter as jwc
from objectcentricocccompletion_torch.configs.ococcnet_config import (
    tiny_config)
from objectcentricocccompletion_torch.data.tracklet_dataset import (
    TrackletDataset)
from objectcentricocccompletion_torch.tools import create_data
from objectcentricocccompletion_torch.tools_ctrl import extend_tracks as text
from objectcentricocccompletion_torch.tools_ctrl import (
    generate_tracklets as tgt)
from objectcentricocccompletion_torch.tools_occ import scenes
from objectcentricocccompletion_torch.tools_occ import waymo_raw_converter as twc
from tests.test_tools_ctrl import frame_points_provider, make_bins
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401
from tests.test_waymo_raw_converter import (_write_fixture_tfrecord,
                                            encode_frame_with_pose)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the small LiDARs of the CLI tests (the card runs scenes.SENSORS)
SENSORS = {"TOP": (16, 256), "FRONT": (24, 96), "SIDE_LEFT": (24, 96),
           "SIDE_RIGHT": (24, 96), "REAR": (24, 96)}


def jax_cli():
    """The JAX repository's ``tools/create_data.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_create_data", os.path.join(ROOT, "tools", "create_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same(a, b, where=""):
    """Nested dicts / lists / tuples / dataclasses of arrays equal, dtype
    and bytes."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if a.dtype == object:
            assert_same(list(a), list(b), where)
        else:
            assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, (where, a, b)


def load_tree(root):
    """Every pkl, npy and npz under ``root`` -> {relative path: content}."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".pkl"):
                with open(path, "rb") as fh:
                    out[rel] = pickle.load(fh)
            elif f.endswith(".npy"):
                out[rel] = np.load(path, allow_pickle=True)
            elif f.endswith(".npz"):
                out[rel] = dict(np.load(path))
    return out


def test_waymo_raw_converter_equals_the_jax_package(tmp_path):
    """The fixture segment through both converters (the port's through its
    CLI), a frame with a frame pose and a TOP pixel pose through both
    parsers and ``frame_to_raw``, and the TFRecord framing."""
    tf_dir = tmp_path / "tf"
    tf_dir.mkdir()
    _write_fixture_tfrecord(str(tf_dir / "seg-0.tfrecord"))
    jwc.convert_segment(str(tf_dir / "seg-0.tfrecord"),
                        str(tmp_path / "jax"), "0000")
    assert create_data.main(["waymo_raw", "--tfrecord-dir", str(tf_dir),
                             "--out-dir", str(tmp_path / "port")]) == 3
    j, t = load_tree(tmp_path / "jax"), load_tree(tmp_path / "port")
    assert len(j) == 3
    assert_same(j, t)

    H, W = 16, 128
    rng = np.random.RandomState(0)
    incl = np.linspace(-0.3, 0.2, H)
    ext = np.eye(4)
    ext[:3, 3] = [1.0, 0.2, 1.9]
    ri = np.zeros((H, W, 4), np.float32)
    ri[rng.rand(H, W) < 0.3, 0] = rng.uniform(3, 40, 1).astype(np.float32)
    pose6 = rng.uniform(-0.1, 0.1, (H, W, 6)).astype(np.float32)
    frame_pose = np.eye(4)
    frame_pose[:3, 3] = [10.0, -2.0, 0.3]
    buf = encode_frame_with_pose(5, [(1, incl, ext)], [(1, ri, ri * 1.1)],
                                 frame_pose, pose6)
    jf, tf = jwc.parse_frame(buf), twc.parse_frame(buf)
    assert_same(jf, tf)
    assert_same(jwc.frame_to_raw(jf), twc.frame_to_raw(tf))
    jwc.write_tfrecord(str(tmp_path / "r.tfrecord"), [buf, b"", b"x" * 7])
    assert list(jwc.read_tfrecord(str(tmp_path / "r.tfrecord"))) == \
        list(twc.read_tfrecord(str(tmp_path / "r.tfrecord")))


def test_tracklet_tools_equal_the_jax_package(tmp_path):
    """``tracklets_from_bin``, ``assign_candidates``,
    ``write_tracklet_dataset`` (pkls and point npys), ``extend_record`` /
    ``extend_bin``, ``merge_bins`` and ``extract_poses``."""
    poses = make_bins(tmp_path)
    for name in ("pd.bin", "gt.bin"):
        assert_same(jgt.tracklets_from_bin(str(tmp_path / name)),
                    tgt.tracklets_from_bin(str(tmp_path / name)))
    jp, jg = (jgt.tracklets_from_bin(str(tmp_path / n))
              for n in ("pd.bin", "gt.bin"))
    tp, tg = (tgt.tracklets_from_bin(str(tmp_path / n))
              for n in ("pd.bin", "gt.bin"))
    assert [[c.id for c in cl] for cl in jgt.assign_candidates(jp, jg)] == \
        [[c.id for c in cl] for cl in tgt.assign_candidates(tp, tg)]
    for pkg, mod in (("jax", jgt), ("port", tgt)):
        mod.write_tracklet_dataset(str(tmp_path / "pd.bin"),
                                   str(tmp_path / "gt.bin"),
                                   frame_points_provider(),
                                   str(tmp_path / pkg), poses)
    assert_same(load_tree(tmp_path / "jax"), load_tree(tmp_path / "port"))

    # extension: a constant-velocity track, poses moving the ego
    full_ts = [1_000_000 + i * 100_000 for i in range(14)]
    ext_poses = {}
    for i, t in enumerate(full_ts):
        pose = np.eye(4)
        pose[:3, 3] = [0.5 * i, 0.1 * i, 0.0]
        ext_poses[t] = pose
    rec = jp[0]
    rec = dataclasses.replace(rec, ts=full_ts[3:3 + len(rec)])
    for kw in ({"extend_length": 2, "min_length": 2},
               {"min_length": 2, "extend_all": True}):
        j = jext.extend_record(rec, ext_poses, full_ts, **kw)
        t = text.extend_record(tgt.TrackletRecord(**dataclasses.asdict(rec)),
                               ext_poses, full_ts, **kw)
        assert_same(j, t)
    with open(tmp_path / "poses.pkl", "wb") as f:
        pickle.dump(ext_poses, f)
    with open(tmp_path / "ctx.pkl", "wb") as f:
        pickle.dump({"seg-b": full_ts}, f)
    pkl = {"poses_pkl": str(tmp_path / "poses.pkl"),
           "context2ts_pkl": str(tmp_path / "ctx.pkl")}
    assert jext.extend_bin(str(tmp_path / "pd.bin"),
                           out_path=str(tmp_path / "je.bin"), **pkl) == \
        text.extend_bin(str(tmp_path / "pd.bin"),
                        out_path=str(tmp_path / "te.bin"), **pkl)
    assert (tmp_path / "je.bin").read_bytes() == \
        (tmp_path / "te.bin").read_bytes()
    jext.merge_bins([str(tmp_path / "pd.bin"), str(tmp_path / "gt.bin")],
                    str(tmp_path / "jm.bin"))
    text.merge_bins([str(tmp_path / "pd.bin"), str(tmp_path / "gt.bin")],
                    str(tmp_path / "tm.bin"))
    assert (tmp_path / "jm.bin").read_bytes() == \
        (tmp_path / "tm.bin").read_bytes()
    infos = [{"point_cloud": {"velodyne_path": f"velodyne/{i:06d}.bin"},
              "pose": ext_poses[t]} for i, t in enumerate(full_ts)]
    with open(tmp_path / "infos.pkl", "wb") as f:
        pickle.dump(infos, f)
    for name, value in (("idx2ts.pkl", {f"{i:06d}": t for i, t in
                                        enumerate(full_ts)}),
                        ("idx2ctx.pkl", {f"{i:06d}": "seg-b"
                                         for i in range(len(full_ts))})):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(value, f)
    args = ([str(tmp_path / "infos.pkl")], str(tmp_path / "idx2ts.pkl"),
            str(tmp_path / "idx2ctx.pkl"))
    assert_same(jext.extract_poses(*args, str(tmp_path / "jx")),
                text.extract_poses(*args, str(tmp_path / "tx")))
    assert_same(load_tree(tmp_path / "jx"), load_tree(tmp_path / "tx"))


def test_create_data_occ_annotate_and_seeds_equal_the_jax_cli(tmp_path):
    """``occ_annotate`` of the port's CLI (``--device cpu``) against the
    JAX repository's ``cmd_occ_annotate`` on a two-segment dataset of
    ``scenes.write_annotation_dataset`` (five small LiDARs, range images of
    the frames' own points): every npz equal byte for byte, the same files;
    then ``fsdpp_seeds`` against ``SeedStore.from_results_bin``."""
    p = scenes.write_annotation_dataset(str(tmp_path / "data"),
                                        num_points=6000, num_boxes=6,
                                        sensors=SENSORS)
    common = dict(gt_bin=p["gt_bin"], infos=p["infos"],
                  data_root=p["data_root"], raw_root=p["raw_root"],
                  voxel_size=0.2, min_track_len=10)
    jax_cli().cmd_occ_annotate(argparse.Namespace(
        out_dir=str(tmp_path / "jax"), workers=1, num_shards=1, shard=0,
        **common))
    argv = ["occ_annotate"] + [
        a for k, v in common.items()
        for a in (f"--{k.replace('_', '-')}", str(v))]
    assert create_data.main(argv + ["--out-dir", str(tmp_path / "port"),
                                    "--device", "cpu"]) == 4
    j, t = load_tree(tmp_path / "jax"), load_tree(tmp_path / "port")
    assert sorted(j) == ["seg-0/gt_0.npz", "seg-0/gt_1.npz",
                         "seg-1/gt_0.npz", "seg-1/gt_1.npz"]
    assert_same(j, t)
    for grid in t.values():
        counts = np.bincount(grid["occ"].ravel(), minlength=3)
        assert (counts > 0).all(), counts      # unknown, occupied and free

    store = create_data.main(["fsdpp_seeds", "--results-bin", p["pred_bin"],
                              "--out", str(tmp_path / "seeds.pkl"),
                              "--score-thr", "0.5"])
    ref = jss.SeedStore.from_results_bin(p["pred_bin"], score_thr=0.5)
    assert_same(ref.frames, store.frames)
    assert len(store.frames) == 20
    with open(tmp_path / "seeds.pkl", "rb") as f:
        assert_same(pickle.load(f)["frames"], ref.frames)


def test_create_data_tracklets_equals_the_jax_cli_and_loads(tmp_path):
    """``tracklets`` of the port's CLI against the JAX repository's
    ``cmd_tracklets`` (pkls and point npys equal), then the port's
    ``TrackletDataset`` on the result with the annotated grids."""
    p = scenes.write_annotation_dataset(str(tmp_path / "data"),
                                        num_points=6000, num_boxes=6,
                                        sensors=SENSORS)
    common = dict(pred_bin=p["pred_bin"], gt_bin=p["gt_bin"],
                  infos=p["infos"], data_root=p["data_root"])
    jax_cli().cmd_tracklets(argparse.Namespace(out_dir=str(tmp_path / "jax"),
                                               **common))
    argv = ["tracklets"] + [a for k, v in common.items()
                            for a in (f"--{k.replace('_', '-')}", v)]
    paths = create_data.main(argv + ["--out-dir", str(tmp_path / "port")])
    assert_same(load_tree(tmp_path / "jax"), load_tree(tmp_path / "port"))

    occ = str(tmp_path / "occ")
    create_data.main(["occ_annotate", "--gt-bin", p["gt_bin"], "--infos",
                      p["infos"], "--data-root", p["data_root"],
                      "--raw-root", p["raw_root"], "--out-dir", occ,
                      "--device", "cpu"])
    ds = TrackletDataset(occ_anno_root=occ, cfg=tiny_config(),
                         min_tracklet_length=1, min_tracklet_points=1,
                         **paths)
    assert len(ds) == 4
    s = ds.build_sample(0, np.random.RandomState(0))
    assert int(s["points_mask"].sum()) > 0
    assert int(s["gt_valid"].sum()) > 0
