"""The port's frame training pipeline against the JAX package on the CPU:
``write_synthetic_frames`` (poses and sweeps included), ``GTDatabase`` and
``DBSampler``, ``FrameDataset.build_sample`` with multi-sweep loading, the
GT paste, the geometry augmentation and the W8 merge, the batches that
``train_detector`` draws around ``disable_aug_after`` with the hooks of
``training/hooks.py``, one tiny detector's loss on 6-wide (multi-sweep)
points with converted weights, and the training and evaluation CLIs with
the pipeline's flags.

Bars: every array equal (dtype and bytes), draw for draw from the same
``RandomState``; the loss within 2e-5 relative.
"""
import os
import pickle

import jax
import numpy as np
import torch

from objectcentricocccompletion_tpu.data import dbsampler as jdb
from objectcentricocccompletion_tpu.data import frame_dataset as jfd
from objectcentricocccompletion_tpu.models import centerpoint as jcp
from objectcentricocccompletion_tpu.training import detector_trainer as jdt
from objectcentricocccompletion_tpu.training import hooks as jhooks
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.data import dbsampler as tdb
from objectcentricocccompletion_torch.data import frame_dataset as tfd
from objectcentricocccompletion_torch.models import centerpoint as tcp
from objectcentricocccompletion_torch.tools import test as test_cli
from objectcentricocccompletion_torch.tools import train as train_cli
from objectcentricocccompletion_torch.training import hooks as thooks
from tests.test_torch_centerpoint import TINY, cp_frame, random_params
from tests.test_torch_create_data import assert_same
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

AUG = dict(augment=True, flip_ratio_horizontal=0.5, flip_ratio_vertical=0.5,
           translation_std=(0.2, 0.2, 0.1),
           pc_range=(-40.0, -40.0, -3.0, 40.0, 40.0, 3.0), num_sweeps=2)


def frames(root):
    """The same synthetic frames from both packages' writers (held equal
    file for file), and the infos path."""
    kw = dict(num_frames=4, num_points=3000, num_boxes=8, seed=3,
              xy_range=45.0)
    j = jfd.write_synthetic_frames(os.path.join(root, "jax"), **kw)
    t = tfd.write_synthetic_frames(os.path.join(root, "port"), **kw)
    for rel in ["infos.pkl"] + [f"velodyne/{i:06d}.bin" for i in range(4)]:
        with open(os.path.join(root, "jax", rel), "rb") as a, \
                open(os.path.join(root, "port", rel), "rb") as b:
            if rel.endswith(".pkl"):
                ja, tb = pickle.load(a), pickle.load(b)
                assert_same(ja, tb, rel)
                assert [len(i["sweeps"]) for i in tb] == [0, 1, 2, 3]
            else:
                assert a.read() == b.read(), rel
    return t


def occ_files(root, info_path):
    """Seeded [K, 4] predicted occupancy files under each frame (W8)."""
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    rng = np.random.RandomState(0)
    for info in infos:
        d = os.path.join(root, info["segment_name"], str(info["timestamp"]))
        os.makedirs(d, exist_ok=True)
        rng.uniform(-20, 20, (50, 4)).astype(np.float32).tofile(
            os.path.join(d, "1_0.bin"))
    return root


def test_build_sample_with_sweeps_paste_and_augmentation(tmp_path):
    """The GT database built from each package's dataset, then samples of
    every frame from ``FrameDataset(augment=True, num_sweeps=2,
    pc_range=..., db_sampler=DBSampler(...), occ_pred_root=...)``, three
    passes from one ``RandomState``: equal array for array."""
    info = frames(str(tmp_path))
    root = os.path.dirname(info)
    occ = occ_files(str(tmp_path / "occ"), info)
    kw = dict(max_points=9000, max_gt=24, occ_pred_root=occ, **AUG)
    jds = jfd.FrameDataset(info, root, **kw)
    tds = tfd.FrameDataset(info, root, **kw)
    assert tds.point_dim == 6
    jdb_ = jdb.GTDatabase.build_from_frames(jds, min_points=4)
    tdb_ = tdb.GTDatabase.build_from_frames(tds, min_points=4)
    assert len(tdb_) > 10 and sorted(tdb_.entries) == [0, 1, 2]
    assert_same(jdb_.entries, tdb_.entries, "entries")
    tdb_.save(str(tmp_path / "db.pkl"))
    assert_same(tdb.GTDatabase.build_or_load(
        tds, str(tmp_path / "db.pkl")).entries, jdb_.entries, "cache")
    jds.db_sampler = jdb.DBSampler(jdb_, {0: 10, 1: 12, 2: 9}, seed=5)
    tds.db_sampler = tdb.DBSampler(tdb_, {0: 10, 1: 12, 2: 9}, seed=5)
    jr, tr = np.random.RandomState(7), np.random.RandomState(7)
    pasted = 0
    for _ in range(3):
        for i in range(len(tds)):
            j, t = jds.build_sample(i, jr), tds.build_sample(i, tr)
            assert_same(j, t, f"frame {i}")
            assert t["points"].shape == (9000, 6)
            lag = t["points"][t["points_mask"], 5]
            assert set(np.unique(lag)) <= {0.0, -1.0, -2.0}
            assert (lag == -min(i, 2)).any()
            pasted += int(t["gt_valid"].sum())
    assert pasted > 3 * 4 * 8


def test_disable_aug_after_draws_what_the_jax_trainer_draws(tmp_path):
    """``train_detector(disable_aug_after=2)`` on tiny CenterPoint with
    6-wide points: the samples it draws equal those of the JAX trainer's
    loader under the same switch (augmentation and paste on for the first
    two batches, off from the third), and the hooks of both packages fire
    alike."""
    info = frames(str(tmp_path))
    root = os.path.dirname(info)
    kw = dict(max_points=4096, max_gt=32, **AUG)
    tds = tfd.FrameDataset(info, root, **kw)
    db = train_cli.attach_gt_sampler(tds, 3, min_points=4)
    jds = jfd.FrameDataset(info, root, **kw)
    jds.db_sampler = jdb.DBSampler(
        jdb.GTDatabase.build_from_frames(jds, min_points=4, max_frames=2000),
        {lab: 3 for lab in db.entries}, seed=0)
    drawn = []
    build = tds.build_sample

    def record(index, rng):
        s = build(index, rng)
        drawn.append((tds.augment, tds.db_sampler is not None, s))
        return s
    tds.build_sample = record
    seen = []
    model = train_cli.build_detector("centerpoint", tiny=True, device="cpu",
                                     generator=torch.Generator().manual_seed(
                                         0), point_dim=tds.point_dim)
    done = train_cli.train_detector(
        model, tds, str(tmp_path / "work"), total_steps=4, device="cpu",
        log_interval=1, disable_aug_after=2,
        hooks=[lambda step, m: seen.append((step, tds.augment))])
    assert done == 4 and seen == [(1, True), (2, True), (3, False),
                                  (4, False)]
    assert [d[:2] for d in drawn] == [(True, True)] * 2 + [(False, False)] * 2
    loader = jdt.FrameLoader(jds, 1, seed=0)
    for step, (_, _, t) in enumerate(drawn):
        if step == 2:       # the JAX trainer's switch, before the draw
            jds.augment, jds.db_sampler = False, None
        j = next(loader)
        for k, a in zip(jdt.FrameBatch._fields, j):
            assert_same(np.asarray(a)[0], t[k], f"step {step} {k}")

    for mod in (jhooks, thooks):
        ds = type("D", (), {"augment": True})()
        hooks = mod.HookList().add(3, lambda: None, "noop")
        hooks.hooks.append(mod.disable_augmentation_hook(ds, at_step=2))
        states = []
        for step in range(5):
            hooks.on_step(step)
            states.append(ds.augment)
        assert states == [True, True, False, False, False]
        assert [mod.loss_weight_warmup(2)(s) for s in range(4)] == \
            [0.0, 0.0, 1.0, 1.0]


def test_six_wide_centerpoint_loss_equals_the_jax_package():
    """Tiny CenterPoint on points with the time-lag column (6 wide, as
    ``--num-sweeps`` gives them): the JAX model's params (its first Dense
    reads the width off the input) through ``convert`` into
    ``DynamicCenterPoint(point_dim=6)``; the losses within 2e-5
    relative, and the tree back through the converter equal."""
    points, mask, boxes, labels, valid = cp_frame(TINY, seed=4)
    rng = np.random.RandomState(4)
    lag = -rng.randint(0, 3, (len(points), 1)).astype(np.float32)
    points = np.concatenate([points, np.where(mask[:, None], lag, 0)], -1)
    model = jcp.DynamicCenterPoint(TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), points, mask)
    params = random_params(shapes["params"], seed=5)
    assert params["vfe"]["vfe_0"]["kernel"].shape[0] == 6 + 6
    ref = jax.jit(lambda p: model.apply({"params": p}, points, mask, boxes,
                                        labels, valid,
                                        method=model.loss))(params)
    cfg = train_cli.with_point_dim(tcp.CenterPointConfig(
        **{f: getattr(TINY, f) for f in TINY.__dataclass_fields__}), 6)
    port = tcp.DynamicCenterPoint(cfg, device="cpu")
    port.load_state_dict(convert.flax_to_state_dict(params))
    got = port.train().loss(*(torch.tensor(x) for x in (
        points, mask, boxes, labels, valid)))
    for k in ("loss_heatmap", "loss_bbox", "loss"):
        assert abs(float(got[k].detach()) - float(ref[k])) <= 2e-5 * abs(
            float(ref[k])), k
    back = convert.state_dict_to_flax(port.state_dict())
    assert_same(jax.tree_util.tree_map(np.asarray, params),
                jax.tree_util.tree_map(np.asarray, back))


def test_cli_trains_and_evaluates_with_the_pipeline(tmp_path):
    """``tools/train.py`` takes ``--augment --gt-sample --gt-db-cache
    --num-sweeps --disable-aug-after`` (tiny SST, the CPU): it trains, the
    database is cached, the checkpoint's first Dense is 6 + 6 wide, and
    ``tools/test.py --num-sweeps`` evaluates the checkpoint."""
    info = tfd.write_synthetic_frames(str(tmp_path / "frames"), num_frames=3,
                                      num_points=3000, num_boxes=6,
                                      xy_range=9.0, seed=4)
    root = os.path.dirname(info)
    work, cache = str(tmp_path / "work"), str(tmp_path / "db.pkl")
    common = ["--infos", info, "--data-root", root, "--tiny", "--device",
              "cpu", "--num-sweeps", "2"]
    steps = []
    assert train_cli.main(
        ["sst", *common, "--total-steps", "3", "--work-dir", work,
         "--augment", "--gt-sample", "3", "--gt-db-cache", cache,
         "--gt-db-min-points", "4", "--disable-aug-after", "1",
         "--log-interval", "1"],
        hooks=[lambda s, m: steps.append(float(m["loss"]))]) == 3
    assert os.path.exists(cache) and len(steps) == 3
    assert all(np.isfinite(steps))
    ckpt = torch.load(os.path.join(work, "ckpt", "step_3.pt"),
                      weights_only=True)["model"]
    assert ckpt["backbone.vfe.vfe_0.weight"].shape[1] == 6 + 6
    metrics = test_cli.main(["sst", *common, "--ckpt-dir",
                             os.path.join(work, "ckpt")])
    assert set(metrics) == {"Car_3d_easy", "Car_3d_moderate",
                            "Car_3d_hard"}
