"""The port's frame data and SST training loop held against the JAX
package on the CPU: ``write_synthetic_frames`` and ``FrameDataset`` give
the same arrays, ``FrameLoader`` the same batches, and a twin run of the
tiny detector (one converted init, the same batches, the JAX
``make_detector_train_step`` against the port's) tracks the JAX losses.
Then the port's CLI trains, logs, checkpoints and resumes on the CPU."""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.data import frame_dataset as jfd
from objectcentricocccompletion_tpu.models import sst_detector as jdet
from objectcentricocccompletion_tpu.parallel.train import make_mesh
from objectcentricocccompletion_tpu.training import detector_trainer as jdt
from objectcentricocccompletion_tpu.training.optim import (
    make_optimizer as jax_make_optimizer)
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.data import frame_dataset as tfd
from objectcentricocccompletion_torch.models import sst_detector as tdet
from objectcentricocccompletion_torch.tools import train as ttrain
from objectcentricocccompletion_torch.training import detector_trainer as tdt
from objectcentricocccompletion_torch.training.optim import make_optimizer
from tests.test_torch_sst import _random_params, _torch_config

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


TWIN_STEPS = 5


def test_twin_training(frames):
    """Five steps of two frames each at base_lr 1e-4 (peak 1e-2 after the
    first step), from one converted init on the same batches."""
    info, root = frames
    kw = dict(max_points=2048, max_gt=TINY.max_gt)
    jloader = jdt.FrameLoader(jfd.FrameDataset(info, root, **kw), 2, seed=1)
    tloader = tdt.FrameLoader(tfd.FrameDataset(info, root, **kw), 2, seed=1)

    model = jdet.SSTDetector(TINY)
    first = next(jloader)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            first.points[0], first.points_mask[0])
    params = jax.tree_util.tree_map(np.asarray,
                                    _random_params(shapes["params"], 2))
    tx, _ = jax_make_optimizer(1e-4, TWIN_STEPS)
    state = jdt.DetectorState(jnp.zeros((), jnp.int32), params,
                              tx.init(params))
    jstep = jdt.make_detector_train_step(model, tx,
                                         make_mesh(jax.devices()[:1]))

    tmodel = tdet.SSTDetector(_torch_config(TINY), device="cpu")
    tmodel.load_state_dict(convert.flax_to_state_dict(params))
    opt, schedule = make_optimizer(tmodel.named_parameters(), 1e-4,
                                   TWIN_STEPS)
    tstep = tdt.make_detector_train_step(tmodel, opt, schedule)

    jl, tl = [], []
    for step in range(TWIN_STEPS):
        jb = first if step == 0 else next(jloader)
        tb = next(tloader)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        state, aux = jstep(state, jb, jax.random.PRNGKey(step))
        got = tstep(step, tb)
        for k in ("loss_cls", "loss_bbox", "loss_dir", "num_pos_anchors",
                  "grad_norm"):
            assert k in got and np.isfinite(float(got[k])), k
        jl.append(float(aux["loss"]))
        tl.append(float(got["loss"]))
    jl, tl = np.asarray(jl), np.asarray(tl)
    rel = np.abs(tl - jl) / np.abs(jl)
    print(f"twin losses jax {jl} port {tl} max rel dev {rel.max():.2e}")
    assert abs(jl[-1] - jl[0]) > 0.05 * jl[0]     # the weights moved
    # the repository's twin-training bar: 6e-3
    assert rel.max() <= 6e-3, rel
    final = convert.state_dict_to_flax(
        {n: p for n, p in tmodel.named_parameters()})
    flat_ref = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, state.params))[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(final)[0])
    diffs = {jax.tree_util.keystr(p): np.abs(flat_got[p] - r).max()
             for p, r in flat_ref}
    key_bias = {k for k in diffs if k.endswith("['k']['bias']")}
    worst = max(v for k, v in diffs.items() if k not in key_bias)
    print(f"twin final params max abs diff {worst:.2e}, attention key "
          f"biases {max(diffs[k] for k in key_bias):.2e}")
    # a hundredth of one step at the peak rate (1e-2): atol 1e-4
    assert worst <= 1e-4, diffs
    # the softmax is invariant to the key bias: its exact gradient is 0,
    # and Adam turns the float32 noise there into steps of up to lr in
    # either direction, so the two runs may part by twice the sum of lr
    lr_sum = sum(schedule(s) for s in range(TWIN_STEPS))
    assert all(diffs[k] <= 2 * lr_sum for k in key_bias)


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


@pytest.mark.parametrize("extra", [["centerpoint"], ["sst", "--augment"],
                                   ["sst", "--dataset", "nuscenes"],
                                   ["sst", "--gt-sample", "2"],
                                   ["sst", "--num-sweeps", "1"]])
def test_cli_refuses_what_is_not_ported(frames, extra):
    info, root = frames
    argv = extra + ["--infos", info, "--data-root", root, "--device", "cpu"]
    with pytest.raises(NotImplementedError):
        ttrain.main(argv)
