"""The port's frame data and SST training loop held against the JAX
package on the CPU: ``write_synthetic_frames`` and ``FrameDataset`` give
the same arrays, ``FrameLoader`` the same batches, and a twin run of the
tiny detector (one converted init, the same batches, the JAX
``make_detector_train_step`` against the port's) tracks the JAX losses.
Then the port's CLI trains, logs, checkpoints and resumes on the CPU. The
twin run is in ``test_torch_sst_twin_steps.py``."""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.data import dbsampler as jdb
from objectcentricocccompletion_tpu.data import frame_dataset as jfd
from objectcentricocccompletion_tpu.models import sst_detector as jdet
from objectcentricocccompletion_torch.data import dbsampler as tdb
from objectcentricocccompletion_torch.data import frame_dataset as tfd
from objectcentricocccompletion_torch.tools import train as ttrain
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TINY = jdet.tiny_sst_detector_config()
# frames inside the tiny config's +-9.6 m range
FRAMES = dict(num_frames=3, num_points=3000, num_boxes=6, xy_range=9.0)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames"))
    return tfd.write_synthetic_frames(root, seed=4, **FRAMES), root


def test_synthetic_frames_and_samples_equal_the_jax_package(
        tmp_path, frames):
    info, root = frames
    jinfo = jfd.write_synthetic_frames(str(tmp_path), seed=4, **FRAMES)
    for i in range(FRAMES["num_frames"]):
        name = f"velodyne/{i:06d}.bin"
        with open(os.path.join(root, name), "rb") as a, \
                open(os.path.join(tmp_path, name), "rb") as b:
            assert a.read() == b.read()
    with open(info, "rb") as a, open(jinfo, "rb") as b:
        assert pickle.dumps(pickle.load(a)) == pickle.dumps(pickle.load(b))
    # 2048 < 3000 points: the subsampling draws from the rng
    tds = tfd.FrameDataset(info, root, max_points=2048, max_gt=8)
    jds = jfd.FrameDataset(info, root, max_points=2048, max_gt=8)
    assert len(tds) == len(jds) == FRAMES["num_frames"]
    for i in range(len(tds)):
        a = tds.build_sample(i, np.random.RandomState(i))
        b = jds.build_sample(i, np.random.RandomState(i))
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["gt_valid"].sum() == FRAMES["num_boxes"]


@pytest.mark.parametrize("option", [
    dict(augment=True), dict(db_sampler=True), dict(num_sweeps=2)])
def test_options_not_ported_raise(frames, option):
    """The options that ``FrameDataset`` refused until the frame training
    pipeline was ported (the augmentation, the GT paste with a sampler of
    the frames' own database, multi-sweep loading) now build the JAX
    package's samples, array for array from the same ``RandomState``."""
    info, root = frames
    kw = dict(max_points=2048, max_gt=12, **option)
    datasets = []
    for fd, db in ((jfd, jdb), (tfd, tdb)):
        ds = fd.FrameDataset(info, root, **{**kw, "db_sampler": None})
        if option.get("db_sampler"):
            ds.db_sampler = db.DBSampler(db.GTDatabase.build_from_frames(
                ds, min_points=4), {0: 8, 1: 8, 2: 8}, seed=1)
        datasets.append(ds)
    jr, tr = np.random.RandomState(2), np.random.RandomState(2)
    for i in range(FRAMES["num_frames"]):
        a, b = (ds.build_sample(i, r) for ds, r in zip(datasets, (jr, tr)))
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert b["points"].shape[1] == 5 + bool(option.get("num_sweeps"))


def write_occ_predictions(info, occ_root, frames=2, files=2, rows=300,
                          seed=0):
    """Seeded float32 [rows, 4] occupancy files in ``save_occ``'s layout,
    ``<root>/<segment>/<ts>/<type>_<id>.bin``, for the first ``frames``
    frames of ``info``; returns the rows written per frame."""
    rng = np.random.RandomState(seed)
    infos = pickle.load(open(info, "rb"))
    for inf in infos[:frames]:
        d = os.path.join(occ_root, inf["segment_name"],
                         str(inf["timestamp"]))
        os.makedirs(d, exist_ok=True)
        for j in range(files):
            occ = np.concatenate([rng.uniform(-8, 8, (rows, 2)),
                                  rng.uniform(-2, 0, (rows, 1)),
                                  rng.rand(rows, 1)], -1)
            occ.astype(np.float32).tofile(os.path.join(d, f"1_{j}.bin"))
    return [files * rows] * frames + [0] * (len(infos) - frames)


@pytest.mark.parametrize("max_points", [4096, 2048])
def test_occ_pred_root_merges_like_the_jax_package(frames, tmp_path,
                                                   max_points):
    """W8: the predicted occupancy points of a frame join its cloud
    (xyz, the score as intensity, zeros elsewhere); a frame without files
    is left as it is. The samples equal the JAX package's, subsampled or
    not."""
    info, root = frames
    occ_root = str(tmp_path / "occ")
    extra = write_occ_predictions(info, occ_root)
    tds = tfd.FrameDataset(info, root, max_points=max_points, max_gt=8,
                           occ_pred_root=occ_root)
    jds = jfd.FrameDataset(info, root, max_points=max_points, max_gt=8,
                           occ_pred_root=occ_root)
    infos = pickle.load(open(info, "rb"))
    for i in range(len(tds)):
        a = tds.build_sample(i, np.random.RandomState(i))
        b = jds.build_sample(i, np.random.RandomState(i))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        n = min(FRAMES["num_points"] + extra[i], max_points)
        assert a["points_mask"].sum() == n
        occ = tds.load_occ_points(infos[i]["segment_name"],
                                  infos[i]["timestamp"])
        assert occ.shape == (extra[i], 5) and not occ[:, 4:].any()


def test_camera_to_lidar_boxes_matches():
    rng = np.random.RandomState(0)
    annos = dict(name=np.asarray(["Car", "DontCare", "Cyclist", "Tram"]),
                 location=rng.randn(4, 3), dimensions=rng.rand(4, 3) + 1,
                 rotation_y=rng.uniform(-3, 3, 4))
    rect = np.eye(4)
    rect[:3, :3] += 0.01 * rng.randn(3, 3)
    trv2c = np.asarray([[0, -1, 0, 0.1], [0, 0, -1, 0.2], [1, 0, 0, 0.3],
                        [0, 0, 0, 1]], np.float64)
    for a, b in zip(tfd.camera_to_lidar_boxes(annos, rect, trv2c),
                    jfd.camera_to_lidar_boxes(annos, rect, trv2c)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_cli_trains_logs_checkpoints_and_resumes(frames, tmp_path):
    info, root = frames
    work = str(tmp_path / "run")
    argv = ["sst", "--infos", info, "--data-root", root, "--tiny",
            "--device", "cpu", "--work-dir", work, "--total-steps", "2",
            "--log-interval", "1"]
    seen = []
    assert ttrain.main(argv, hooks=[lambda s, m: seen.append(s)]) == 2
    assert seen == [1, 2]
    rows = [json.loads(line)
            for line in open(os.path.join(work, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        for k in ("loss", "loss_cls", "loss_bbox", "loss_dir", "grad_norm",
                  "frames_per_sec"):
            assert np.isfinite(r[k]), k
    assert os.listdir(os.path.join(work, "ckpt")) == ["step_2.pt"]
    # resume: the checkpoint is at total_steps, so no step runs
    seen.clear()
    assert ttrain.main(argv, hooks=[lambda s, m: seen.append(s)]) == 2
    assert seen == []
    ckpt = torch.load(os.path.join(work, "ckpt", "step_2.pt"),
                      weights_only=True)
    assert ckpt["step"] == 2 and "model" in ckpt and "optimizer" in ckpt


@pytest.mark.parametrize("extra", [["votenet"], ["sst", "--tp", "2"],
                                   ["sst", "--dataset", "nuscenes"],
                                   ["sst", "--dataset", "argo2"],
                                   ["sst", "--loader-workers", "2"]])
def test_cli_refuses_what_is_not_ported(frames, extra):
    info, root = frames
    argv = extra + ["--infos", info, "--data-root", root, "--device", "cpu"]
    with pytest.raises(NotImplementedError):
        ttrain.main(argv)
