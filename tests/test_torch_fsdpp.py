"""FSD++ in the port against the JAX package on the CPU at
``tiny_fsdpp_config()``: a 3-frame sequence (two-stage here, single-stage
in ``test_torch_fsdpp_train.py``, which shares its JAX set-up there) from
an incoming state whose memory holds points of every age (so that
``max_age`` evicts some) and whose seeds crop the memory; the two-stage
window step's losses over those frames against the JAX ``two_stage_loss``
of the JAX outputs; then
``tools/train.py fsdpp --tiny --device cpu`` with resume and ``tools/test.py
fsdpp`` with the KITTI metric, held against the JAX ``_sequential_results``
on the same weights.

Each frame of the sequence runs twice in the port: fed the JAX step's
incoming state and grouping (the outputs, the novel mask, the memory update
and the seeds against that step; two-stage FSD's second stage also on the
JAX step's proposals), and free-running on its own state and grouping (the
discrete state against JAX's at every frame).

Bars: the discrete state exactly equal (the merged mask, the memory, its
mask and age, the seeds' validity and labels, the cluster validity); floats
within 2e-5 of max(1, each output's largest value); losses within 2e-5
relative.

The JAX references are ``jax.jit`` of ``model.apply`` (eager FSD++ costs
more than a minute per step), compiled once for the file. A file of at most
four tests (pytest-xdist's ``--dist loadfile``; ``test_torch_fsd.py``)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.data import frame_dataset as jfd
from objectcentricocccompletion_tpu.evalx import detector_eval as jde
from objectcentricocccompletion_tpu.evalx import kitti_eval as jke
from objectcentricocccompletion_tpu.models import fsd_two_stage as jfts
from objectcentricocccompletion_tpu.models import fsdpp as jpp
from objectcentricocccompletion_tpu.ops import seeds as jseeds
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.data import frame_dataset as tfd
from objectcentricocccompletion_torch.evalx import detector_eval as tde
from objectcentricocccompletion_torch.models import fsd as tfsd
from objectcentricocccompletion_torch.models import fsdpp as tpp
from objectcentricocccompletion_torch.ops import seeds as tseeds
from objectcentricocccompletion_torch.tools import test as tcli
from objectcentricocccompletion_torch.tools import train as ttrain
from objectcentricocccompletion_torch.training import seq_trainer as tst
from objectcentricocccompletion_torch.training.optim import make_optimizer
from tests.test_fsd import CLS_SIZES, make_fsd_frame
from tests.test_torch_fsd import (OUT_KEYS, assert_close, port_config,
                                  random_params)
from tests.test_torch_fsd_loss import LOSS_RTOL
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TINY = jpp.tiny_fsdpp_config()
STAGE2_KEYS = ("cls2", "bbox2", "refined_boxes")
# frames inside the tiny config's +-9.6 m range, one segment
FRAMES = dict(num_frames=3, num_points=3000, num_boxes=8, xy_range=8.0)


def port_fsdpp_config(cfg):
    return dataclasses.replace(
        tpp.tiny_fsdpp_config(), fsd=port_config(cfg.fsd),
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__
           if f != "fsd"})


def sequence_frames(cfg, seed):
    """Three frames: a frame, the same frame with its objects moved 0.9 m
    in x (its background seen before), and another frame; three boxes
    each, of every class of the config."""
    n = cfg.fsd.num_classes
    f0 = [np.array(a) for a in make_fsd_frame(
        cfg.fsd, seed=seed, num_boxes=3, classes=[0, 1 % n, 2 % n])]
    f1 = [a.copy() for a in f0]
    f1[0][800:int(f1[1].sum()), 0] += 0.9
    f1[2][:3, 0] += 0.9
    f2 = [np.array(a) for a in make_fsd_frame(
        cfg.fsd, seed=seed + 1, num_boxes=3, classes=[2 % n, 0, 1 % n])]
    return [tuple(f) for f in (f0, f1, f2)]


def incoming_state(cfg, frame, seed):
    """A state in the middle of a sequence: 2,500 memory points of ages 0
    to ``max_age`` (some inside the frame's GT boxes) and valid seeds on
    those boxes and elsewhere (numpy, the JAX state's dtypes)."""
    rng = np.random.RandomState(seed)
    lo, hi = np.float32(cfg.fsd.pc_range[:3]), np.float32(cfg.fsd.pc_range[3:])
    m, n, feat = cfg.memory_size, 2500, frame[0].shape[-1]
    memory = np.zeros((m, feat), np.float32)
    memory[:n, :3] = rng.uniform(lo, hi, (n, 3))
    memory[:600, :3] = frame[0][800:1400, :3] + rng.normal(0, 0.1, (600, 3))
    memory[:n, 3:] = rng.rand(n, feat - 3)
    mask = np.arange(m) < n
    age = np.where(mask, rng.randint(0, cfg.max_age + 1, m), 0)
    s = cfg.max_seeds
    boxes = np.zeros((s, 7), np.float32)
    boxes[:3] = frame[2][:3]
    boxes[3:8] = np.concatenate([rng.uniform(-6, 6, (5, 2)),
                                 np.full((5, 1), -1.0), np.full((5, 3), 2.0),
                                 rng.uniform(-3, 3, (5, 1))], -1)
    seeds = jseeds.Seeds(boxes, rng.randint(0, cfg.fsd.num_classes,
                                            s).astype(np.int32),
                         rng.uniform(0.2, 0.9, s).astype(np.float32),
                         np.arange(s) < 8)
    return jpp.SequenceState(memory, mask, age.astype(np.int32), seeds)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def torch_state(state):
    s = to_torch(state)
    return tpp.SequenceState(s.memory, s.memory_mask, s.memory_age,
                             tseeds.Seeds(*s.seeds))


def jax_forward(cfg):
    """The jitted JAX sequence step, capturing the wrapped detector's
    grouping: ``(params, state, points, mask) -> ((new state, out),
    grouping)``."""
    model = jpp.FSDPP(cfg)
    owner = "stage1" if cfg.two_stage else "fsd"

    def run(p, state, points, mask):
        res, inter = model.apply(
            {"params": p}, state, points, mask, mutable=["intermediates"],
            capture_intermediates=lambda mdl, name: (
                mdl.name == owner and name == "group"))
        node = inter["intermediates"]["fsd"]
        return res, (node["stage1"] if cfg.two_stage else node)["group"][0]

    return jax.jit(run)


def init_params(cfg, seed):
    """Seeded flax params over the tree that ``convert`` writes for the
    port's model (tracing the JAX ``init`` for its shapes costs seconds;
    the jitted JAX forward then takes these params as they are)."""
    shapes = convert.state_dict_to_flax(
        {n: p for n, p in tpp.FSDPP(port_fsdpp_config(cfg),
                                    device="cpu").named_parameters()})
    params = random_params(shapes, seed)
    seg = params["fsd"]["stage1"] if cfg.two_stage else params["fsd"]
    seg["seg_head"]["Dense_1"]["kernel"] *= 0.1     # short votes
    return params


def torch_fsdpp(params, cfg):
    model = tpp.FSDPP(port_fsdpp_config(cfg), device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(params))
    return model.eval()


def assert_state_equal(got, ref, what):
    ref = jax.tree_util.tree_map(np.asarray, ref)
    for name in ("memory", "memory_mask", "memory_age"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(ref, name),
                                      err_msg=f"{what} {name}")
    np.testing.assert_array_equal(got.seeds.valid.numpy(), ref.seeds.valid,
                                  err_msg=f"{what} seed validity")
    np.testing.assert_array_equal(got.seeds.labels.numpy(),
                                  ref.seeds.labels, err_msg=f"{what} labels")
    assert got.seeds.labels.dtype == torch.int32
    for name in ("boxes", "scores"):
        assert_close(getattr(got.seeds, name), getattr(ref.seeds, name),
                     f"{what} seed {name}")


def check_sequence(cfg, fwd, params, frames, state):
    """Run the JAX step over ``frames`` from ``state``; the port fed each
    JAX step's input, and free-running. Returns the JAX states."""
    model = torch_fsdpp(params, cfg)
    tree = convert.state_dict_to_flax(
        {n: p for n, p in model.named_parameters()})
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    own = torch_state(state)
    states, crops = [state], []
    for i, (points, mask, *_) in enumerate(frames):
        (new, out), group = fwd(params, state, points, mask)
        out = jax.tree_util.tree_map(np.asarray, out)
        pts, msk = torch.from_numpy(points), torch.from_numpy(mask)
        with torch.no_grad():
            got_state, got = model(torch_state(state), pts, msk,
                                   grouping=tfsd.Grouping(*to_torch(group)))
            own, _ = model(own, pts, msk)
        what = f"frame {i}"
        np.testing.assert_array_equal(got["input_mask"].numpy(),
                                      out["input_mask"], err_msg=what)
        for k in ("cluster_valid", "cluster_class") + (
                ("roi_nonempty",) if cfg.two_stage else ()):
            np.testing.assert_array_equal(got[k].numpy(), out[k],
                                          err_msg=f"{what} {k}")
        for k in OUT_KEYS:
            assert_close(got[k], out[k], f"{what} {k}")
        if cfg.two_stage:
            # stage 2 on JAX's proposals (its own differ in the last bits,
            # which its RoI features amplify to 2.2e-5 of bbox2's largest)
            with torch.no_grad():
                _, merged, merged_mask = model.inputs(torch_state(state),
                                                      pts, msk)
                refined = model.fsd.refine(merged, merged_mask, dict(
                    got, boxes=torch.tensor(out["rois"])))
            for k in STAGE2_KEYS:
                assert_close(refined[k], out[k], f"{what} {k}")
        assert_state_equal(got_state, new, what)
        assert_state_equal(own, new, f"{what}, free-running")
        state = jax.tree_util.tree_map(np.asarray, new)
        states.append(state)
        crops.append(int(out["input_mask"][points.shape[0]:].sum()))
    return states, crops


def check_counts(cfg, frames, states, crops):
    """The sequence exercises what it should at every frame: the seeds
    crop the memory, novel points enter it, points of the oldest age leave
    it, and the detections give seeds."""
    for i, (frame, before, after) in enumerate(zip(frames, states,
                                                   states[1:])):
        aged = (before.memory_age + 1 > cfg.max_age) & before.memory_mask
        fresh = after.memory_mask & (after.memory_age == 0)
        assert aged.any() and crops[i] > 0, i
        assert 0 < fresh.sum() <= frame[1].sum(), i
        assert after.memory_mask.sum() == fresh.sum() + (
            before.memory_mask & ~aged).sum(), i
        assert after.seeds.valid.any(), i


@pytest.fixture(scope="module")
def two_stage():
    frames = sequence_frames(TINY, seed=11)
    state = incoming_state(TINY, frames[0], seed=12)
    params = init_params(TINY, seed=13)
    return frames, state, params, jax_forward(TINY)


def test_two_stage_sequence_equals_the_jax_package(two_stage):
    frames, state, params, fwd = two_stage
    states, crops = check_sequence(TINY, fwd, params, frames, state)
    check_counts(TINY, frames, states, crops)
    # frame 1 repeats frame 0's background: only moved points are novel
    fresh = [int((s.memory_mask & (s.memory_age == 0)).sum())
             for s in states[1:]]
    assert fresh[1] < fresh[0] / 2 and fresh[2] > fresh[1], fresh


def box_proposals(params):
    """``params`` with stage 1's box regression set to each task's class
    size, no offset and yaw 0 (the last Dense of every centre, size and
    rotation branch: kernels 0, biases those values), so that some
    proposals on random weights overlap their GT box enough to be stage-2
    positives."""
    p = jax.tree_util.tree_map(np.array, params)
    for name, branch in p["fsd"]["stage1"]["head"].items():
        task, _, kind = name.partition("_")
        if kind in ("center", "dim", "rot"):
            last = branch["Dense_2"]
            last["kernel"][:] = 0.0
            last["bias"][:] = {
                "center": 0.0, "rot": np.float32([0.0, 1.0]),
                "dim": np.log(np.float32(CLS_SIZES[int(task[4:])]))}[kind]
    return p


def test_two_stage_window_losses_equal_the_jax_loss(two_stage):
    """Two-stage FSD++'s window step over the three frames (the seed
    augmentation off, JAX's groupings fed; stage 1's boxes set by
    :func:`box_proposals`): its mean losses against the
    JAX ``two_stage_loss`` of each frame's jitted JAX outputs on ``[points;
    the memory that frame was given]``, averaged; the state it hands on;
    finite gradients. (Gradients against JAX: the JAX two-stage window
    step compiles in 35-60 s here; ``test_torch_fsdpp_train.py`` holds the
    single-stage one, ``test_torch_fsd_two_stage.py`` two-stage FSD's.)"""
    frames, state, params, fwd = two_stage
    params = box_proposals(params)
    loss = jax.jit(jfts.two_stage_loss)
    ref, groupings, mem = {}, [], state
    for points, mask, *gt in frames:
        (new, out), group = fwd(params, mem, points, mask)
        merged = np.concatenate([points, np.asarray(mem.memory)], 0)
        for k, v in loss(out, merged, *gt).items():
            ref[k] = ref.get(k, 0.0) + float(v) / len(frames)
        groupings.append((tfsd.Grouping(*to_torch(group)), None))
        mem = new
    model = torch_fsdpp(params, TINY)
    opt, schedule = make_optimizer(model.named_parameters(), 1e-5, 10)
    step_fn = tst.make_seq_train_step(model, opt, schedule, len(frames),
                                      seed_aug=False)
    batch = tst.SeqWindow(*(torch.from_numpy(np.stack(a))
                            for a in zip(*frames)))
    got_state, got = step_fn(0, batch, torch_state(state),
                             overrides=groupings)
    assert set(got) == set(ref) | {"grad_norm"}
    for k, r in ref.items():
        assert abs(float(got[k]) - r) <= LOSS_RTOL * max(abs(r), 1e-3), \
            (k, float(got[k]), r)
    assert ref["num_pos_rois2"] > 0 and ref["loss_reg2"] > 0
    assert_state_equal(got_state, mem, "two-stage window state")
    assert all(torch.isfinite(p.grad).all()
               for p in model.parameters() if p.grad is not None)


def jax_sequential_step(fwd):
    """``make_sequential_predict_fn``'s step built on ``fwd`` (the same
    jitted ``model.apply``, compiled once for the file)."""
    def make(model):
        def step(params, mem, points, mask):
            (new_mem, out), _ = fwd(params, mem, points, mask)
            return new_mem, (out["boxes"],
                             jax.nn.sigmoid(jnp.max(out["cls"], -1)),
                             jnp.argmax(out["cls"], -1), out["cluster_valid"])
        return step
    return make


def test_cli_trains_resumes_and_evaluates(two_stage, tmp_path, monkeypatch):
    """``tools/train.py fsdpp --tiny --device cpu`` for a step, then
    resumed to 2 (``--log-interval`` ignored, as by the JAX CLI); then
    ``tools/test.py fsdpp --metric kitti`` on the checkpoint against the
    JAX ``_sequential_results`` and ``kitti_eval`` on the same weights,
    frame by frame."""
    *_, fwd = two_stage
    root = str(tmp_path / "frames")
    info = tfd.write_synthetic_frames(root, seed=9, **FRAMES)
    work = str(tmp_path / "work")
    argv = ["fsdpp", "--infos", info, "--data-root", root, "--work-dir",
            work, "--tiny", "--device", "cpu", "--log-interval", "1"]
    seen = []

    def hook(step, metrics):
        assert all(np.isfinite(float(v)) for v in metrics.values())
        assert "loss_cls2" in metrics and "grad_norm" in metrics
        seen.append(step)

    assert ttrain.main(argv + ["--total-steps", "1"], hooks=[hook]) == 1
    assert ttrain.main(argv + ["--total-steps", "2"], hooks=[hook]) == 2
    assert seen == [1, 2]
    assert os.listdir(os.path.join(work, "ckpt")) == ["step_2.pt"]
    assert open(os.path.join(work, "metrics.jsonl")).read() == ""

    flags = ["fsdpp", "--infos", info, "--data-root", root, "--ckpt-dir",
             os.path.join(work, "ckpt"), "--tiny", "--device", "cpu",
             "--score-thresh", "0.0"]
    kitti = tcli.main(flags + ["--metric", "kitti"])
    assert len(kitti) == 3 and all(0 <= v <= 100 for v in kitti.values())

    model = ttrain.build_detector("fsdpp", tiny=True, device="cpu")
    tcli._restore(model, os.path.join(work, "ckpt"))
    params = convert.state_dict_to_flax(
        {n: p for n, p in model.named_parameters()})
    monkeypatch.setattr(jde, "make_sequential_predict_fn",
                        jax_sequential_step(fwd))
    kw = dict(max_points=TINY.fsd.max_points, max_gt=32)
    ref = list(jde._sequential_results(
        jpp.FSDPP(TINY), params, jfd.FrameDataset(info, root, **kw), 0.0,
        0.25, None, 0))
    got = list(tde._sequential_results(
        model.eval(), tfd.FrameDataset(info, root, **kw), 0.0, 0.25, None,
        0))
    assert len(got) == len(ref) == FRAMES["num_frames"]
    for i, ((p, g, _), (jp, jg, _)) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(p["labels"], jp["labels"])
        assert_close(p["boxes"], jp["boxes"], f"frame {i} boxes")
        assert_close(p["scores"], jp["scores"], f"frame {i} scores")
        for k in g:
            np.testing.assert_array_equal(g[k], jg[k])
    assert sum(len(p["boxes"]) for p, _, _ in got) > 0
    ref_ap = jke.kitti_eval([p for p, _, _ in ref], [g for _, g, _ in ref])
    assert set(ref_ap) == set(kitti)
    for k, v in ref_ap.items():
        assert abs(kitti[k] - v) <= 1e-3, (k, kitti[k], v)
