"""The traffic pools: repeatable from a seed, the lengths and buckets the
mix asks for, real frames counted as the rate counts them."""
from __future__ import annotations

import torch

from portbench import harness, traffic

REFINE = harness.load_json(harness.HERE / "traffic" / "refine.json")
DETECT = harness.load_json(harness.HERE / "traffic" / "detect.json")


def test_lengths_repeat_and_span():
    a = traffic.tracklet_lengths(REFINE, traffic.generator(7, 1, "cpu"))
    b = traffic.tracklet_lengths(REFINE, traffic.generator(7, 1, "cpu"))
    c = traffic.tracklet_lengths(REFINE, traffic.generator(8, 1, "cpu"))
    assert a == b and a != c
    assert len(a) == REFINE["tracklets"]
    assert min(a) >= REFINE["min_len"] and max(a) <= REFINE["max_len"]
    # log-uniform: about as many under the geometric mean (40) as over
    under = sum(L < 40 for L in a)
    assert 0.3 * len(a) < under < 0.7 * len(a)


def test_buckets():
    assert [traffic.bucket_of(T, REFINE["buckets"])
            for T in (1, 32, 33, 64, 200, 257)] == [32, 32, 64, 64, 256, 320]


def test_calls_hold_every_tracklet_once():
    lengths = traffic.tracklet_lengths(REFINE, traffic.generator(3, 1, "cpu"))
    calls = traffic.plan_calls(lengths, REFINE["buckets"],
                               REFINE["frames_per_call"],
                               traffic.generator(3, 4, "cpu"))
    real = [i for c in calls for i in c.ids[:c.real_tracklets]]
    assert sorted(real) == list(range(len(lengths)))
    for c in calls:
        assert len(c.ids) * c.L == REFINE["frames_per_call"]
        assert c.real_frames == sum(lengths[i]
                                    for i in c.ids[:c.real_tracklets])
        # repeats fill the call with its last real tracklet
        assert set(c.ids[c.real_tracklets:]) <= {c.ids[c.real_tracklets - 1]}
        assert all(lengths[i] <= c.L for i in c.ids)
    padded = sum(c.L * c.real_tracklets for c in calls)
    # log-uniform 8-200 frames into buckets of 32-256: about 2/3 real
    assert 0.55 < sum(lengths) / padded < 0.8


def test_tracklets_repeat_and_pad():
    mix = dict(REFINE, tracklets=5, max_len=20)
    a = traffic.make_tracklets(mix, 64, 8, 11, "cpu")
    b = traffic.make_tracklets(mix, 64, 8, 11, "cpu")
    for x, y in zip(a[2:], b[2:]):
        assert torch.equal(x, y)
    assert sum(a.length) == len(a.points) == len(a.rois)
    n = a.points_mask.sum(-1)
    assert int(n.min()) >= min(mix["min_points"], 64)
    call = traffic.Call([0, 1], 32, a.length[0] + a.length[1], 2)
    t = traffic.call_tensors(a, call)
    T = a.length[0]
    assert t["points"].shape == (2, 32, 64, 10)
    assert not t["points_mask"][0, T:].any()
    assert torch.equal(t["rois"][0, T:], a.rois[T - 1].expand(32 - T, 7))
    assert torch.equal(t["frame_inds"][0], torch.arange(32,
                                                        dtype=torch.int32))


def test_frames_repeat():
    from portbench.tests import tiny
    mix = dict(tiny.cell("sst.detect")["mix"], frames=2)
    rng = (-9.6, -9.6, -2.0, 9.6, 9.6, 4.0)
    a = traffic.make_frames(mix, 2048, rng, 5, "cpu")
    b = traffic.make_frames(mix, 2048, rng, 5, "cpu")
    c = traffic.make_frames(mix, 2048, rng, 6, "cpu")
    assert all(torch.equal(x[0], y[0]) for x, y in zip(a, b))
    assert not torch.equal(a[0][0], c[0][0])
    pts, mask = a[0]
    n = int(mask.sum())
    assert pts.shape == (2048, 5) and 1000 < n <= 2048
    assert torch.equal(mask, torch.arange(2048) < n)
    lo, hi = torch.tensor(rng[:3]), torch.tensor(rng[3:])
    assert ((pts[:n, :3] >= lo) & (pts[:n, :3] < hi)).all()


def _density(pts, r0, r1):
    r = pts[:, :2].norm(dim=-1)
    return int(((r >= r0) & (r < r1)).sum()) / (torch.pi * (r1 ** 2 - r0 ** 2))


def test_frames_fall_with_range_alike_for_every_seed():
    """At the cell's geometry (fewer azimuths): returns per square metre
    fall with range, and every seed casts into the same wall distances and
    object ranges, so two seeds' frames hold about as many points."""
    mix = dict(DETECT, frames=2)
    mix["lidar"] = dict(mix["lidar"], azimuths=600)
    rng = (-74.88, -74.88, -2.0, 74.88, 74.88, 4.0)
    frames = [f for seed in (1, 2)
              for f in traffic.make_frames(mix, 160000, rng, seed, "cpu")]
    counts = [int(m.sum()) for _, m in frames]
    assert max(counts) < 1.1 * min(counts)
    for pts, m in frames:
        p = pts[m]
        assert _density(p, 0, 10) > 5 * _density(p, 10, 30) > 25 * \
            _density(p, 30, 75)
