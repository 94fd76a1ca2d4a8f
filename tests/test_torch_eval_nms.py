"""The port's rotated IoU matrices, NMS and KITTI AP held against the JAX
package on the CPU, on random rotated boxes (clusters of overlapping boxes
so that the NMS suppresses and the AP matches). Bars: IoU within 1e-5,
kept indices and AP exact except where an IoU lies within 1e-5 of a
threshold (none does on these seeds; the tests check that)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectcentricocccompletion_tpu.core import boxes as jboxes
from objectcentricocccompletion_tpu.data.frame_dataset import (
    FrameDataset as JFrames)
from objectcentricocccompletion_tpu.evalx import detector_eval as jdet
from objectcentricocccompletion_tpu.evalx import kitti_eval as jkitti
from objectcentricocccompletion_tpu.evalx import waymo_metrics as jwm
from objectcentricocccompletion_tpu.models.sst_detector import (
    SSTDetector as JSST, tiny_sst_detector_config as jtiny)
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.core import boxes as tboxes
from objectcentricocccompletion_torch.data.frame_dataset import (
    write_synthetic_frames)
from objectcentricocccompletion_torch.evalx import detector_eval as tdet
from objectcentricocccompletion_torch.evalx import kitti_eval as tkitti
from objectcentricocccompletion_torch.evalx import waymo_metrics as twm
from objectcentricocccompletion_torch.evalx.waymo_bin import read_bin
from objectcentricocccompletion_torch.models.sst_detector import SSTDetector
from objectcentricocccompletion_torch.tools import test as tcli
from objectcentricocccompletion_torch.tools import train as ttrain
from objectcentricocccompletion_torch.training.trainer import (
    CheckpointManager)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

IOU_TOL = 1e-5


def _clusters(rng, n, spread=0.6):
    """``n`` boxes around n // 4 centres: neighbours overlap."""
    centres = rng.uniform(-30, 30, (max(n // 4, 1), 2))
    c = centres[rng.randint(0, len(centres), n)] + rng.normal(0, spread,
                                                              (n, 2))
    return np.concatenate([c, rng.uniform(-1, 0.5, (n, 1)),
                           rng.uniform([1.6, 3.5, 1.4], [2.2, 5.0, 1.9],
                                       (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          -1).astype(np.float32)


def _far_from(iou, thresh):
    return not (np.abs(np.asarray(iou) - thresh) < IOU_TOL).any()


def test_iou_matrices_nms_bev_and_host_nms_match():
    rng = np.random.RandomState(0)
    a, b = _clusters(rng, 40), _clusters(rng, 24)
    for name in ("pairwise_iou_bev", "pairwise_iou_3d"):
        x = np.concatenate([a, b])
        got = getattr(tboxes, name)(torch.from_numpy(x), torch.from_numpy(a))
        ref = jax.jit(getattr(jboxes, name))(x, a)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=IOU_TOL, rtol=0, err_msg=name)
        # clusters overlap off the diagonal
        assert (got.numpy() > 0.05).sum() > len(a) + 20, name
    scores = rng.rand(40).astype(np.float32)
    jnms = jax.jit(jboxes.nms_bev, static_argnums=(2, 3))
    iou = np.asarray(jax.jit(jboxes.pairwise_iou_bev)(a, a))
    for thresh, max_out in ((0.1, 12), (0.3, 50)):
        assert _far_from(iou, thresh)
        keep, valid = tboxes.nms_bev(torch.from_numpy(a),
                                     torch.from_numpy(scores), thresh,
                                     max_out)
        rkeep, rvalid = (np.array(x) for x in jnms(a, scores, thresh,
                                                     max_out))
        assert 0 < valid.sum() < 40
        if max_out > len(a):
            # the JAX version sends the suppressed boxes to slot n, which
            # lies inside the output when max_out > n: one suppressed box
            # shows there as kept. The port leaves the slot empty.
            assert rvalid[len(a)] and rkeep[len(a)] not in rkeep[:len(a)]
            rkeep[len(a)], rvalid[len(a)] = -1, False
        np.testing.assert_array_equal(valid.numpy(), rvalid)
        np.testing.assert_array_equal(keep.numpy(), rkeep)
    keep, valid = tboxes.nms_bev(torch.zeros(0, 7), torch.zeros(0), 0.5, 4)
    assert keep.tolist() == [-1] * 4 and not valid.any()
    # host_nms: 3D IoU, greedy on the host
    rng = np.random.RandomState(1)
    for n, thresh, max_out in ((60, 0.25, 200), (60, 0.1, 7), (1, 0.25, 5),
                               (0, 0.25, 5)):
        b = _clusters(rng, n)
        s = rng.rand(n).astype(np.float32)
        if n > 1:
            assert _far_from(tkitti._pairwise_iou3d(b, b), thresh)
        got = tdet.host_nms(b, s, thresh, max_out)
        ref = jdet.host_nms(b, s, thresh, max_out)
        assert got.dtype == ref.dtype == np.int64
        np.testing.assert_array_equal(got, ref)
        if n > 1:
            assert 1 < len(got) < n


def test_kitti_eval_matches():
    """Per-frame predictions (GT moved a little, some missed, some false)
    through both ``kitti_eval``s, three classes with annos-style
    difficulty."""
    rng = np.random.RandomState(2)
    preds, gts = [], []
    for _ in range(6):
        g = _clusters(rng, int(rng.randint(3, 12)), spread=8.0)
        labels = rng.randint(0, 3, len(g)).astype(np.int32)
        diff = tkitti.difficulty_from_annos(dict(
            name=["Car"] * len(g),
            bbox=np.stack([np.zeros(len(g)), np.zeros(len(g)),
                           np.zeros(len(g)), rng.uniform(20, 60, len(g))],
                          -1),
            occluded=rng.randint(0, 3, len(g)),
            truncated=rng.uniform(0, 0.6, len(g))))
        hit = rng.rand(len(g)) < 0.8
        p = g[hit] + rng.normal(0, 0.1, (int(hit.sum()), 7)).astype(
            np.float32) * [1, 1, 0.5, 0.2, 0.2, 0.2, 0.2]
        fp = _clusters(rng, 3, spread=8.0)
        boxes = np.concatenate([p, fp]).astype(np.float32)
        preds.append(dict(
            boxes=boxes, scores=rng.rand(len(boxes)).astype(np.float32),
            labels=np.concatenate([labels[hit],
                                   rng.randint(0, 3, 3)]).astype(np.int32)))
        gts.append(dict(boxes=g, labels=labels, difficulty=diff))
    classes = ("Car", "Pedestrian", "Cyclist")
    for p, g in zip(preds, gts):
        iou = tkitti._pairwise_iou3d(p["boxes"], g["boxes"])
        np.testing.assert_allclose(
            iou, jkitti._pairwise_iou3d(p["boxes"], g["boxes"]),
            atol=IOU_TOL, rtol=0)
        assert _far_from(iou, 0.7) and _far_from(iou, 0.5)
    np.testing.assert_array_equal(
        tkitti.gt_difficulty(np.array([50, 30, 30, 10.0]),
                             np.array([0, 1, 2, 0]),
                             np.array([0.1, 0.2, 0.4, 0.0])),
        jkitti.gt_difficulty(np.array([50, 30, 30, 10.0]),
                             np.array([0, 1, 2, 0]),
                             np.array([0.1, 0.2, 0.4, 0.0])))
    for kw in ({}, {"iou_thresh": {"Car": 0.5}}):
        got = tkitti.kitti_eval(preds, gts, classes=classes, **kw)
        ref = jkitti.kitti_eval(preds, gts, classes=classes, **kw)
        assert got == ref, kw
        assert 0 < got["Car_3d_hard"] < 1 or 0 < got["Car_3d_moderate"] < 1


@pytest.fixture(scope="module")
def sst_run(tmp_path_factory):
    """Two tiny frames, a checkpoint of ``tools/train.py sst --tiny``, its
    weights in the JAX package's tree and the JAX predict, jitted once."""
    tmp = tmp_path_factory.mktemp("sst_eval")
    root = str(tmp / "frames")
    infos = write_synthetic_frames(root, num_frames=2, num_points=4000,
                                   num_boxes=12)
    work = str(tmp / "sst")
    ttrain.main(["sst", "--infos", infos, "--data-root", root, "--tiny",
                 "--device", "cpu", "--total-steps", "1", "--work-dir", work])
    # lift the classification bias so that the decode's 0.1 score floor
    # keeps boxes of the barely trained model
    ckpt = CheckpointManager(f"{work}/ckpt")
    path = ckpt.path(ckpt.steps()[-1])
    state = torch.load(path, weights_only=True)
    state["model"]["head.cls.bias"] += 3.0
    torch.save(state, path)
    model = SSTDetector(ttrain.sst_train_config(tiny=True), device="cpu")
    ckpt.restore(model)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.state_dict_to_flax(model.state_dict()))
    jmodel = JSST(jtiny())
    jpredict = jdet.make_predict_fn(jmodel, "sst")
    return tmp, infos, root, work, jmodel, params, jpredict


@pytest.mark.parametrize("metric", ["kitti", "waymo"])
def test_cli_evaluates_sst_frames(metric, sst_run, monkeypatch):
    """``tools/test.py sst`` on a checkpoint of ``tools/train.py sst --tiny``
    against ``evaluate_detector*`` of the JAX package on the same weights
    (carried over by ``convert.py``) and the same frames: the metrics
    within 1e-5, the Waymo GT file byte for byte, the predictions' records
    at 1e-5 (scores) and 1e-4 m / rad (boxes; relative above 1: the
    barely trained size regression gives lengths of 100 m and more)."""
    tmp, infos, root, work, jmodel, params, jpredict = sst_run
    out = str(tmp / f"eval_{metric}")
    got = tcli.main(["sst", "--infos", infos, "--data-root", root, "--tiny",
                     "--device", "cpu", "--ckpt-dir", f"{work}/ckpt",
                     "--score-thresh", "0", "--metric", metric,
                     "--out-dir", out])
    ds = JFrames(infos, root, max_points=4096, max_gt=32)
    if metric == "kitti":
        ref = jdet.evaluate_detector(jmodel, "sst", params, ds,
                                     score_thresh=0.0, predict_fn=jpredict)
        assert got.keys() == ref.keys()
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-5, k
        return
    monkeypatch.setattr(jwm, "ensure_built", twm.ensure_built)
    ref = jdet.evaluate_detector_waymo(
        jmodel, "sst", params, ds, str(tmp / "jax"),
        classes=("Car", "Pedestrian", "Cyclist"), score_thresh=0.0,
        predict_fn=jpredict)
    assert open(f"{out}/gt.bin", "rb").read() == \
        open(tmp / "jax" / "gt.bin", "rb").read()
    tp = read_bin(f"{out}/pred.bin")
    jp = read_bin(str(tmp / "jax" / "pred.bin"))
    assert len(tp) == len(jp) > 0
    for a, b in zip(tp, jp):
        assert (a["id"], a["type"], a["context_name"], a["timestamp"]) == \
            (b["id"], b["type"], b["context_name"], b["timestamp"])
        assert abs(a["score"] - b["score"]) <= 1e-5
        for k in range(1, 8):
            assert abs(a["box"][k] - b["box"][k]) <= \
                1e-4 * max(1.0, abs(b["box"][k])), k
    assert got.keys() == ref.keys()
    for k in ref:
        if k != "_raw":
            assert abs(got[k] - ref[k]) <= 1e-5, k
