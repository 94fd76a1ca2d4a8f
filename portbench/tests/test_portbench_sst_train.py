"""The ``sst.train`` cell's parts on the CPU: its frames are ``sst.detect``'s
and its labels hold the objects the rays hit; the reference's loss,
gradients and AdamW step against the port's at the tiny size; the
attention backward's roofline reader."""
from __future__ import annotations

import types

import pytest
import torch

from portbench import harness, traffic, weights
from portbench.reference import sst as ref
from portbench.tests import frames_unlabelled, tiny, tiny_sst

DETECT = harness.load_json(harness.HERE / "traffic" / "detect.json")
TRAIN = harness.load_json(harness.HERE / "traffic" / "sst_train.json")
TINY_RANGE = (-9.6, -9.6, -2.0, 9.6, 9.6, 4.0)


@pytest.mark.parametrize("seed", (5, 2 ** 31 + 11, 987654321013))
def test_detect_frames_unchanged(seed):
    """``sst.detect``'s frames, at its own scene and sizes (fewer
    azimuths), bit for bit as before the labels, with or without them."""
    mix = dict(DETECT, frames=2)
    mix["lidar"] = dict(mix["lidar"], azimuths=400)
    rng = (-74.88, -74.88, -2.0, 74.88, 74.88, 4.0)
    want = frames_unlabelled.make_frames(mix, 160000, rng, seed, "cpu")
    got = traffic.make_frames(mix, 160000, rng, seed, "cpu")
    labelled = traffic.make_frames(mix, 160000, rng, seed, "cpu",
                                   labels=True)
    for w, g, lab in zip(want, got, labelled):
        assert len(g) == 2 and len(lab) == 4
        for a, b, c in zip(w, g, lab):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_sst_train_scene_is_detects():
    for k in ("frames", "lidar", "walls", "objects", "feat_dim", "assumed"):
        assert TRAIN[k] == DETECT[k], k


def test_label_boxes_hold_their_returns():
    """With no walls, drops or noise every return off the ground lies in
    the box of an object, in the port's box convention; each box has its
    class's anchor sizes."""
    from objectcentricocccompletion_torch.core.boxes import points_in_boxes
    mix = dict(tiny.cell("sst.train")["mix"], frames=2)
    mix["walls"] = dict(mix["walls"], open=1.0)
    mix["lidar"] = dict(mix["lidar"], drop=0.0, range_noise_m=0.0)
    anchors = tiny_sst.config()["anchors"]["sizes"]
    for seed in (3, 4):
        for pts, msk, boxes, classes in traffic.make_frames(
                mix, 2048, TINY_RANGE, seed, "cpu", labels=True):
            p = pts[msk, :3]
            off = p[p[:, 2] > 1e-3]
            inside = points_in_boxes(off[None], boxes[:, None],
                                     (2e-3, 2e-3, 2e-3))[:, 0]
            assert len(off) > 50 and inside.any(0).all()
            assert int((inside.sum(1) > 0).sum()) >= len(boxes) // 2
            want = torch.tensor(anchors)[classes]
            assert torch.allclose(boxes[:, 3:6], want)
            assert (boxes[:, 2] == 0).all()
            assert ((boxes[:, 6] >= -torch.pi)
                    & (boxes[:, 6] < torch.pi)).all()


def test_frame_labels_keep_the_grid_and_pad():
    boxes = torch.tensor([[1.0, 2.0, 0, 1, 2, 1, 0], [20.0, 0, 0, 1, 2, 1, 0],
                          [-3.0, -9.0, 0, 1, 2, 1, 0.5]])
    lab = traffic.frame_labels(boxes, torch.tensor([2, 0, 1]), TINY_RANGE, 4)
    assert torch.equal(lab["gt_valid"], torch.tensor([True, True, False,
                                                      False]))
    assert torch.equal(lab["gt_boxes"][:2], boxes[[0, 2]])
    assert (lab["gt_boxes"][2:] == 0).all()
    assert lab["gt_labels"].dtype == torch.int32
    assert lab["gt_labels"].tolist() == [2, 1, 0, 0]


def _labelled_frame(cfg, seed):
    mix = dict(tiny.cell("sst.train")["mix"], frames=1)
    s = cfg["sst"]
    pts, msk, boxes, classes = traffic.make_frames(
        mix, s["max_points"], s["pc_range"], seed, "cpu", labels=True)[0]
    return dict(points=pts, mask=msk, **traffic.frame_labels(
        boxes, classes, s["pc_range"], cfg["max_gt"]))


def test_sst_loss_and_gradients_match_port():
    """The reference's loss terms and every parameter's gradient against
    ``SSTDetector.loss`` and its backward, on seeded weights."""
    from portbench.modes import sst_train
    cfg = tiny_sst.config()
    params = weights.draw(ref.param_specs(cfg), 7, "cpu")
    model = sst_train.build_detector(cfg, None, "cpu").train()
    model.load_state_dict(params)
    frame = _labelled_frame(cfg, 9)
    got = model.loss(frame["points"], frame["mask"], frame["gt_boxes"],
                     frame["gt_labels"], frame["gt_valid"])
    got["loss"].backward()
    r = ref.step_grads(params, cfg, frame)
    assert int(got["num_pos_anchors"]) == int(r["losses"]["num_pos"]) > 0
    for k in ("loss_cls", "loss_bbox", "loss_dir", "loss"):
        assert abs(float(got[k].detach()) - r["losses"][k]) <= 1e-5 * abs(
            r["losses"][k]), k
    for n, p in model.named_parameters():
        want = r["grads"][n]
        assert torch.allclose(p.grad, want, rtol=1e-4,
                              atol=1e-4 * float(want.abs().max()) + 1e-6), n


def test_sst_adamw_step_matches_port_optimizer():
    """The check's optimizer step: AdamW worked out from the port
    optimizer's own state and a given gradient, well into the schedule,
    at the mix's recipe, on a decayed weight and two leaves without
    decay."""
    from objectcentricocccompletion_torch.training.optim import \
        make_optimizer, set_lr
    opt = TRAIN["optimizer"]
    g = torch.Generator().manual_seed(5)
    leaves = {n: torch.nn.Parameter(torch.randn(*shape, generator=g))
              for n, shape in (("backbone.layers.0.q.weight", (8, 4)),
                               ("backbone.layers.0.q.bias", (8,)),
                               ("neck_norms.0.weight", (8,)))}
    total = 1000
    optim, sched = make_optimizer(leaves.items(), opt["base_lr"], total,
                                  weight_decay=opt["weight_decay"],
                                  peak_ratio=opt["peak_ratio"])
    for step in range(150):
        before = {n: p.detach().clone() for n, p in leaves.items()}
        moments = tuple({n: optim.state[p][key].clone() if optim.state[p]
                         else torch.zeros_like(p)
                         for n, p in leaves.items()}
                        for key in ("exp_avg", "exp_avg_sq"))
        grads = {n: torch.randn(p.shape, generator=g) * 0.1
                 for n, p in leaves.items()}
        for n, p in leaves.items():
            p.grad = grads[n].clone()
        set_lr(optim, sched(step))
        optim.step()
        want, (m1, m2) = ref.adamw(before, moments, grads, opt, total, step)
        for n, p in leaves.items():
            assert torch.allclose(p.detach(), want[n], rtol=1e-6,
                                  atol=1e-7), (step, n)
            assert torch.allclose(optim.state[p]["exp_avg"], m1[n],
                                  rtol=1e-6, atol=1e-8), (step, n)
            assert torch.allclose(optim.state[p]["exp_avg_sq"], m2[n],
                                  rtol=1e-6, atol=1e-10), (step, n)


def test_attn_bwd_roofline_reader():
    """The backward kernels' least time over their device time: only
    kernels named ``window_attention_bwd`` count, the forward's not."""
    read = harness.reader("attn_bwd_roofline")
    events = [(0.0, 300.0, "void window_attention_bwd_kernel<16>(...)"),
              (400.0, 500.0, "void window_attention_fwd_kernel<16>(...)"),
              (500.0, 600.0, "void window_attention_bwd_kernel<16>(...)"),
              (600.0, 900.0, "ampere_sgemm_128x64_nn")]
    ctx = types.SimpleNamespace(device_events=events,
                                extra={"attn_bwd_bound_s": 1e-4})
    assert read(ctx) == pytest.approx(100.0 * 1e-4 / 400e-6)
    ctx.extra = {}
    assert read(ctx) is None
    ctx.extra = {"attn_bwd_bound_s": 1e-4}
    ctx.device_events = events[1:2] + events[3:]
    assert read(ctx) is None
