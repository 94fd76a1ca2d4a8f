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

from objectcentricocccompletion_tpu.data import frame_dataset as jfd
from objectcentricocccompletion_tpu.models import sst_detector as jdet
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
    dict(augment=True), dict(db_sampler=object()), dict(num_sweeps=2),
    dict(occ_pred_root="occ")])
def test_options_not_ported_raise(frames, option):
    info, root = frames
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        tfd.FrameDataset(info, root, **option)


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


@pytest.mark.parametrize("extra", [["fsdpp"], ["sst", "--augment"],
                                   ["sst", "--dataset", "nuscenes"],
                                   ["sst", "--gt-sample", "2"],
                                   ["sst", "--num-sweeps", "1"]])
def test_cli_refuses_what_is_not_ported(frames, extra):
    info, root = frames
    argv = extra + ["--infos", info, "--data-root", root, "--device", "cpu"]
    with pytest.raises(NotImplementedError):
        ttrain.main(argv)
