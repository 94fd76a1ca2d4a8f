"""Each plain reference against the port on the CPU at the tiny
configurations, stage by stage where the stage is discrete (the budget's
cut of points, the pillars, the windows) and at the outputs."""
from __future__ import annotations

import torch

from portbench import traffic, weights
from portbench.reference import ococcnet as ref_oc
from portbench.reference import sst as ref_sst
from portbench.tests import tiny, tiny_ococcnet, tiny_sst


def _ococc_batch(cfg, seed=3, L=16, B=2):
    mix = dict(tiny.cell("ococcnet.refine")["mix"], tracklets=B, length=L)
    tr = traffic.make_tracklets(mix, cfg["max_points_per_frame"], 8, seed,
                                "cpu")
    return tr, traffic.train_batch(tr, list(range(B)), L)


def _port_ococc(cfg, params):
    from objectcentricocccompletion_torch.configs.ococcnet_config import \
        OcOccNetConfig
    from objectcentricocccompletion_torch.models.ococcnet import \
        OcOccNetWithLoss
    from portbench.modes import port_config
    model = OcOccNetWithLoss(OcOccNetConfig(**port_config(cfg)), "cpu")
    model.load_state_dict(params)
    return model


def test_budget_keeps_what_the_port_packs():
    cfg = tiny_ococcnet.config()
    params = weights.draw(ref_oc.param_specs(cfg), 1, "cpu")
    model = _port_ococc(cfg, params)
    _, t = _ococc_batch(cfg)
    from objectcentricocccompletion_torch.data.tracklet import TrackletBatch
    layout = model.net.point_layout(TrackletBatch(**t))
    pool = ref_oc.roi_pool(t["points"], t["points_mask"], t["rois"],
                           cfg["extra_wlh"])
    keep = ref_oc.budget_keep(pool["mask"], cfg)
    assert torch.equal(pool["mask"], layout.pool.mask)
    # the budget binds on this batch, and both sides keep the same points
    assert int(keep.sum()) < int(pool["mask"].sum())
    B, L, P = keep.shape
    packed = torch.zeros(B, L * P, dtype=torch.bool)
    for b in range(B):
        packed[b, layout.packed.order[b][layout.packed.valid[b]]] = True
    assert torch.equal(packed.reshape(B, L, P), keep)


def test_refine_matches_port():
    cfg = tiny_ococcnet.config()
    params = weights.draw(ref_oc.param_specs(cfg), 2, "cpu")
    model = _port_ococc(cfg, params).eval()
    tr, t = _ococc_batch(cfg, seed=5)
    t["queries"] = tr.queries[:32].reshape(2, 16, 8, 3)
    from objectcentricocccompletion_torch.data.tracklet import TrackletBatch
    with torch.no_grad():
        out = model.predict(TrackletBatch(**{k: v for k, v in t.items()
                                             if k != "queries"}))
        occ = model.decode_occ_queries(out["shape_latent"], t["queries"])
    r = ref_oc.refine(params, cfg, t)
    assert (out["boxes"] - r["boxes"]).abs().max() < 1e-4
    assert (out["scores"] - r["scores"]).abs().max() < 1e-5
    assert (occ - r["occ"]).abs().max() < 1e-4


def test_hash_matches_port():
    from objectcentricocccompletion_torch.models.layers import hash_bits
    key = torch.tensor([123456789, 7])
    c = torch.arange(1000)
    assert torch.equal(hash_bits(key, (1000,)),
                       ref_oc.hash_bits(123456789, 7, c))
    site = hash_bits(key, (2,), 6)
    assert torch.equal(site, ref_oc.hash_bits(123456789, 7,
                                              torch.arange(6, 8)))


def test_iou_matches_port():
    from objectcentricocccompletion_torch.core.boxes import aligned_iou_3d
    g = torch.Generator().manual_seed(0)
    a = torch.cat([torch.rand(64, 3, generator=g) * 2,
                   0.5 + torch.rand(64, 3, generator=g) * 3,
                   torch.rand(64, 1, generator=g) * 6 - 3], -1)
    b = a + torch.randn(64, 7, generator=g) * 0.4
    b[:, 3:6] = b[:, 3:6].abs() + 0.1
    assert torch.allclose(aligned_iou_3d(a, b), ref_oc.aligned_iou_3d(a, b),
                          atol=1e-5)


def test_train_steps_match_port():
    from objectcentricocccompletion_torch.configs.ococcnet_config import \
        OcOccNetConfig
    from objectcentricocccompletion_torch.data.tracklet import TrackletBatch
    from objectcentricocccompletion_torch.parallel.train import \
        make_train_step
    from objectcentricocccompletion_torch.training.optim import \
        make_optimizer
    from portbench.modes import port_config
    cfg = tiny_ococcnet.config()
    params = weights.draw(ref_oc.param_specs(cfg), 4, "cpu")
    model = _port_ococc(cfg, params)
    pc = OcOccNetConfig(**port_config(cfg))
    opt, sched = make_optimizer(model.named_parameters(), pc.base_lr, 100,
                                weight_decay=pc.weight_decay,
                                peak_ratio=pc.lr_mult)
    step_fn = make_train_step(model, opt, sched, seed=77)
    mix = dict(tiny.cell("ococcnet.train")["mix"])
    tr = traffic.make_tracklets(dict(mix, tracklets=6), 64, 32, 9, "cpu")
    batches = [traffic.train_batch(tr, [2 * i, 2 * i + 1], 8)
               for i in range(3)]
    got = [float(step_fn(i, TrackletBatch(**b))["loss"])
           for i, b in enumerate(batches)]
    r = ref_oc.train_steps(params, cfg, batches, 77, 100)
    for a, b in zip(got, r["losses"]):
        assert abs(a - b["loss"]) < 1e-5 * abs(b["loss"])
    # a leaf whose gradient is nought to rounding (a key's bias under the
    # softmax) moves under Adam by round-off alone: the check's rule
    g = {n: float(v.norm()) for n, v in r["first_grads"].items()}
    med = float(torch.tensor(list(g.values())).median())
    skipped = [n for n in g if g[n] < 1e-3 * med]
    assert all(".self_attn.k.bias" in n for n in skipped) and skipped
    for n, p in model.named_parameters():
        if n not in skipped:
            assert torch.allclose(p.detach(), r["params"][n], atol=1e-7), n


def test_group_max_gradient_at_a_zero_maximum():
    """A frame's maximum that is 0 passes its whole gradient to the point
    (or splits it among tied points), as the port and ``jax.grad`` do."""
    x = torch.tensor([[0.0, -1.0], [2.0, 3.0], [0.0, 3.0]],
                     requires_grad=True)
    out = ref_oc._group_max(x, torch.tensor([0, 1, 1]), 3)
    assert out.tolist() == [[0.0, -1.0], [2.0, 3.0], [0.0, 0.0]]
    out.sum().backward()
    assert x.grad.tolist() == [[1.0, 1.0], [1.0, 0.5], [0.0, 0.5]]


def test_gradients_match_port_with_a_one_point_frame():
    """The training gradients of the tiny batch with one frame cut to a
    single kept point, whose rows are 0 while the biases are: the case
    that the reference's group maximum once halved."""
    from objectcentricocccompletion_torch.data.tracklet import TrackletBatch
    from objectcentricocccompletion_torch.models.layers import DropoutKeys
    cfg = tiny_ococcnet.config()
    params = weights.draw(ref_oc.param_specs(cfg), 4, "cpu")
    model = _port_ococc(cfg, params)
    mix = dict(tiny.cell("ococcnet.train")["mix"])
    tr = traffic.make_tracklets(dict(mix, tracklets=2),
                                cfg["max_points_per_frame"], 32, 9, "cpu")
    b = traffic.train_batch(tr, [0, 1], 8)
    pool = ref_oc.roi_pool(b["points"], b["points_mask"], b["rois"],
                           cfg["extra_wlh"])
    keep = ref_oc.budget_keep(pool["mask"], cfg)
    one = torch.zeros_like(b["points_mask"][0, 3])
    one[torch.nonzero(keep[0, 3]).flatten()[0]] = True
    b["points_mask"][0, 3] = one
    total, _ = model(TrackletBatch(**b), train=True,
                     keys=DropoutKeys(torch.tensor([77, 0])))
    total.backward()
    r = ref_oc.step_grads(params, cfg, b, 77, 0)
    assert abs(float(total.detach()) - r["losses"]["loss"]) < \
        1e-5 * r["losses"]["loss"]
    for n, p in model.named_parameters():
        want = r["grads"][n]
        assert torch.allclose(p.grad, want, rtol=1e-3,
                              atol=1e-3 * float(want.abs().max()) + 1e-6), n


def test_adamw_step_matches_port_optimizer():
    """The check's optimizer step: AdamW worked out from the port
    optimizer's own state and a given gradient, well into the schedule,
    on a decayed weight and two leaves without decay."""
    from objectcentricocccompletion_torch.training.optim import \
        make_optimizer, set_lr
    cfg = tiny_ococcnet.config()
    g = torch.Generator().manual_seed(5)
    leaves = {n: torch.nn.Parameter(torch.randn(*shape, generator=g))
              for n, shape in (("enc.Dense_0.weight", (8, 4)),
                               ("enc.Dense_0.bias", (8,)),
                               ("enc.LayerNorm_0.weight", (8,)))}
    total = 1000
    opt, sched = make_optimizer(leaves.items(), cfg["base_lr"], total,
                                weight_decay=cfg["weight_decay"],
                                peak_ratio=cfg["lr_mult"])
    for step in range(150):
        before = {n: p.detach().clone() for n, p in leaves.items()}
        moments = tuple({n: opt.state[p][key].clone() if opt.state[p]
                         else torch.zeros_like(p)
                         for n, p in leaves.items()}
                        for key in ("exp_avg", "exp_avg_sq"))
        grads = {n: torch.randn(p.shape, generator=g) * 0.1
                 for n, p in leaves.items()}
        for n, p in leaves.items():
            p.grad = grads[n].clone()
        set_lr(opt, sched(step))
        opt.step()
        want, (m1, m2) = ref_oc.adamw(before, moments, grads, cfg, total,
                                      step)
        for n, p in leaves.items():
            assert torch.allclose(p.detach(), want[n], rtol=1e-6,
                                  atol=1e-7), (step, n)
            assert torch.allclose(opt.state[p]["exp_avg"], m1[n],
                                  rtol=1e-6, atol=1e-8), (step, n)
            assert torch.allclose(opt.state[p]["exp_avg_sq"], m2[n],
                                  rtol=1e-6, atol=1e-10), (step, n)


def _sst_frame(cfg, seed=3):
    mix = dict(tiny.cell("sst.detect")["mix"], frames=1)
    s = cfg["sst"]
    return traffic.make_frames(mix, s["max_points"], s["pc_range"], seed,
                               "cpu")[0]


def test_sst_voxels_and_windows_match_port():
    from objectcentricocccompletion_torch.ops import voxelize as vx
    from objectcentricocccompletion_torch.ops import window as win
    cfg = tiny_sst.config()
    s = cfg["sst"]
    pts, mask = _sst_frame(cfg)
    # a budget under the frame's pillars: the cut binds
    s = dict(s, max_voxels=96)
    v = ref_sst.voxelize(pts, mask, s)
    pv = vx.voxelize(pts, mask, s["voxel_size"], s["pc_range"],
                     s["max_voxels"])
    V = len(v["coords"])
    assert int(pv.num_voxels) > s["max_voxels"] == V
    assert torch.equal(pv.coords, v["coords"])
    assert torch.equal(pv.point2voxel, v["p2v"])
    gs = ref_sst.grid_shape(s)
    for shifted in (False, True):
        p = win.partition(pv.coords, pv.voxel_valid, gs, s["window_shape"],
                          shifted, s["max_windows"], 16)
        (level,) = ref_sst.windows(v["coords"], s, shifted)["levels"]
        assert torch.equal(p.win_of_voxel, level["slot"])
        assert torch.equal(p.rank_in_win, level["rank"])


def test_sst_detect_matches_port():
    from objectcentricocccompletion_torch.models import anchor_head as ah
    from objectcentricocccompletion_torch.models import sst as sst_mod
    from objectcentricocccompletion_torch.models.sst_detector import (
        SSTDetector, SSTDetectorConfig)
    from portbench.modes import detect, port_config
    cfg = tiny_sst.config()
    a = port_config(cfg["anchors"])
    a["sizes"] = tuple(map(tuple, a["sizes"]))
    model = SSTDetector(SSTDetectorConfig(
        sst=sst_mod.SSTConfig(**port_config(cfg["sst"])),
        anchors=ah.AnchorConfig(**a), num_classes=cfg["num_classes"],
        neck_channels=cfg["neck_channels"], max_gt=cfg["max_gt"]),
        "cpu").eval()
    params = weights.draw(ref_sst.param_specs(cfg), 6, "cpu")
    model.load_state_dict(params)
    pts, mask = _sst_frame(cfg, 8)
    with torch.no_grad():
        boxes, scores, _, _ = model.predict(pts, mask, 500)
    r = ref_sst.detect(params, cfg, pts, mask)
    top = torch.sort(r["scores"], descending=True).values[:500]
    assert (scores - top).abs().max() < 1e-5
    assert detect.nearest_gap(boxes, r, 500).max() < 1e-4


def test_sst_two_levels_split_by_occupancy():
    cfg = tiny_sst.config()
    s = dict(cfg["sst"], small_capacity=4)
    pts, mask = _sst_frame(cfg)
    v = ref_sst.voxelize(pts, mask, s)
    small, large = ref_sst.windows(v["coords"], s, False)["levels"]
    ms, ml = ref_sst.level_mask(small), ref_sst.level_mask(large)
    assert ms.shape[1] == 4 and ml.shape[1] == 16
    n_s, n_l = ms.sum(1), ml.sum(1)
    assert (n_s[n_s > 0] <= 4).all() and (n_l[n_l > 0] > 4).all()
    # every kept token is on exactly one level
    assert int(n_s.sum() + n_l.sum()) == int(
        ((small["slot"] >= 0) | (large["slot"] >= 0)).sum())
