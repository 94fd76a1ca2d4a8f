"""The port's ``Evaluator.run`` held against the JAX package's on the CPU:
``tiny_config()``, one converted parameter tree, three test tracklets of
12, 20 and 40 frames (length buckets 32 and 64), the same files.

Each case compares the metrics dict (occupancy IoU of the model and of
the point-aggregation baseline, tracklet count) within 1e-5, every record
of ``results.bin`` (scores within 1e-5, ego boxes within 1e-5 and, above
1 m, 1e-5 relative: a float32 coordinate of 6-30 m carries 0.5-2e-6 per
ulp, and the network's float32 outputs part by a few ulps), and in the plain
case the dumped occupancy files (``save_occ``: the same files, xyz and
score within 1e-5). The Waymo metrics come from the port's build of the
native binary (the JAX run skips them)."""
import os
import pickle

import numpy as np
import pytest

from objectcentricocccompletion_tpu.data import tracklet_dataset as jtd
from objectcentricocccompletion_tpu.evalx import evaluator as jev
from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_torch.data import tracklet_dataset as ttd
from objectcentricocccompletion_torch.data.loader import (
    write_synthetic_dataset)
from objectcentricocccompletion_torch.evalx import evaluator as tev
from objectcentricocccompletion_torch.evalx.waymo_bin import read_bin
from tests.test_torch_ococcnet import (TINY, _params, _port_model,
                                       _torch_config)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TOL = 1e-5
LENGTHS = (12, 20, 40)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The dataset (tracklet k cut to LENGTHS[k] frames), both datasets,
    both models and the JAX Evaluators' jitted functions."""
    root = str(tmp_path_factory.mktemp("evaluator"))
    paths = write_synthetic_dataset(os.path.join(root, "ds"),
                                    num_tracklets=len(LENGTHS),
                                    track_len=max(LENGTHS), seed=5)
    with open(paths["proposals_file"], "rb") as f:
        props = pickle.load(f)
    db = paths["proposals_file"].replace(".pkl", "_database")
    for k, T in enumerate(LENGTHS):
        seg, tid, typ, world, boxes, ts, scores, npts = props[k]
        props[k] = (seg, tid, typ, world, boxes[:T], ts[:T], scores[:T],
                    npts[:T])
        pts = os.path.join(db, f"{seg}--{tid}.npy")
        np.save(pts, np.load(pts, allow_pickle=True)[:T], allow_pickle=True)
    with open(paths["proposals_file"], "wb") as f:
        pickle.dump(props, f)
    kw = dict(training=False, min_tracklet_length=1, **paths)
    params = _params("dense")
    return dict(
        root=root, params=params,
        tds=ttd.TrackletDataset(cfg=_torch_config(TINY), **kw),
        jds=jtd.TrackletDataset(cfg=TINY, **kw),
        model=_port_model(TINY, params), jmodel=jnet.OcOccNetWithLoss(TINY),
        jax_evaluators={})


def _jax_evaluator(s, tta, online_tuning_iters):
    """A JAX Evaluator whose jitted functions are shared with the earlier
    ones where they do not depend on its options (the occupancy IoU and
    dump; the predict of the same ``tta``): each compiles once."""
    ev = jev.Evaluator(s["jmodel"], s["params"], s["jds"], TINY, tta=tta,
                       online_tuning_iters=online_tuning_iters)
    cache = s["jax_evaluators"]
    ev._occ_eval = cache.setdefault("occ", {})
    ev._save_occ = cache.setdefault("save_occ", {})
    ev._predict = cache.setdefault(("predict", tta), {})
    return ev


def _compare_records(got_bin, ref_bin, n):
    got, ref = read_bin(got_bin), read_bin(ref_bin)
    assert len(got) == len(ref) == sum(LENGTHS[:n])
    for a, b in zip(got, ref):
        assert (a["id"], a["type"], a["context_name"], a["timestamp"]) == \
            (b["id"], b["type"], b["context_name"], b["timestamp"])
        assert abs(a["score"] - b["score"]) <= TOL
        for k in range(1, 8):
            assert abs(a["box"][k] - b["box"][k]) <= \
                TOL * max(1.0, abs(b["box"][k])), k


def _compare_occ_dumps(got_root, ref_root):
    files = sorted(os.path.relpath(os.path.join(d, f), ref_root)
                   for d, _, fs in os.walk(ref_root) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), got_root)
                           for d, _, fs in os.walk(got_root) for f in fs)
    assert len(files) > 10
    for rel in files:
        a = np.fromfile(os.path.join(got_root, rel), np.float32)
        b = np.fromfile(os.path.join(ref_root, rel), np.float32)
        assert a.shape == b.shape, rel
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=rel)


@pytest.mark.parametrize("case", ["plain", "batch2", "tta", "tune"])
def test_evaluator_run_matches(setup, case, one_torch_thread):
    s = setup
    opts = dict(tta=case == "tta",
                online_tuning_iters=3 if case == "tune" else 0)
    # TTA on the first two tracklets (bucket 32): the JAX TTA graph holds
    # four forwards and compiles once per bucket
    n = 2 if case == "tta" else len(LENGTHS)
    run = dict(batch_size=2 if case == "batch2" else 1,
               eval_occ_baseline=case == "plain", max_tracklets=n)
    if case == "plain":
        run["save_occ_root"] = "occ_dump"
    out = os.path.join(s["root"], case)

    def kw(side):
        return {k: os.path.join(out, side, v) if k == "save_occ_root" else v
                for k, v in run.items()}

    ev = tev.Evaluator(s["model"], s["tds"], _torch_config(TINY),
                       device="cpu", **opts)
    got = ev.run(os.path.join(out, "torch"), **kw("torch"))
    ref = _jax_evaluator(s, **opts).run(os.path.join(out, "jax"),
                                        eval_waymo=False, **kw("jax"))
    assert got["num_tracklets"] == ref["num_tracklets"] == n
    occ = [k for k in ref if k.startswith("occ")]
    assert sorted(occ) == sorted(k for k in got if k.startswith("occ"))
    assert "occ/overall_iou" in occ
    assert ("occ_baseline/overall_iou" in occ) == (case == "plain")
    for k in occ:
        assert abs(got[k] - ref[k]) <= TOL, k
    assert "OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/mAP" in got
    _compare_records(got["results_bin"], ref["results_bin"], n)
    if case == "plain":
        _compare_occ_dumps(os.path.join(out, "torch", "occ_dump"),
                           os.path.join(out, "jax", "occ_dump"))
