"""FSD++'s selection ops, seeds and host code in the port against the JAX
package on the CPU: ``incremental_points_mask`` against the jitted JAX
function with points on voxel edges, every function of ``ops/seeds.py``
(ties, overlapping boxes and the cap, JAX's own uniform draws fed in),
``SeedStore``, ``SequenceLoader`` and ``FrameDataset.sequences``.

Bars: every discrete output exactly equal; floats within 2e-5 of max(1,
their largest value). The JAX references are small jitted functions, so
the file is cheap (pytest-xdist's ``--dist loadfile`` may start it early).
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.data import frame_dataset as jfd
from objectcentricocccompletion_tpu.data import seed_store as jss
from objectcentricocccompletion_tpu.evalx import waymo_bin as jwb
from objectcentricocccompletion_tpu.ops import incremental as jinc
from objectcentricocccompletion_tpu.ops import seeds as jseeds
from objectcentricocccompletion_tpu.training import seq_trainer as jst
from objectcentricocccompletion_torch.data import frame_dataset as tfd
from objectcentricocccompletion_torch.data import seed_store as tss
from objectcentricocccompletion_torch.evalx import waymo_bin as twb
from objectcentricocccompletion_torch.models.fsdpp import FSDPPConfig
from objectcentricocccompletion_torch.ops import incremental as tinc
from objectcentricocccompletion_torch.ops import seeds as tseeds
from objectcentricocccompletion_torch.ops.masked import masked_max, segment_max
from objectcentricocccompletion_torch.ops.routes import Routes, relu
from objectcentricocccompletion_torch.training import seq_trainer as tst
from tests.test_torch_fsd import assert_close
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

FULL = FSDPPConfig()


def t(a):
    return torch.from_numpy(np.array(a))


def jax_seeds(s):
    return jseeds.Seeds(*(jnp.asarray(x.numpy()) for x in s))


def assert_seeds_equal(got, ref, what):
    for name, g, r in zip(got._fields, got, ref):
        r = np.asarray(r)
        assert g.dtype == t(r).dtype, (what, name, g.dtype, r.dtype)
        if name == "valid" or name == "labels":
            np.testing.assert_array_equal(g.numpy(), r, err_msg=what)
        else:
            assert_close(g, r, f"{what} {name}")


def edge_points(voxel_size, pc_range, n, rng):
    """Points whose coordinates sit exactly on voxel edges, computed in
    float32 as ``lo + k * voxel``, and some a float32 step off them."""
    lo = np.float32(pc_range[:3])
    vs = np.float32(voxel_size)
    grid = np.floor((np.float32(pc_range[3:]) - lo) / vs).astype(np.int64)
    k = rng.randint(0, grid + 1, (n, 3))
    xyz = (lo + k.astype(np.float32) * vs).astype(np.float32)
    nudge = rng.randint(-1, 2, (n, 3)).astype(np.float32)
    xyz = np.where(rng.rand(n, 1) < 0.3,
                   np.nextafter(xyz, xyz + nudge), xyz).astype(np.float32)
    return np.concatenate([xyz, rng.rand(n, 2).astype(np.float32)], -1)


@pytest.mark.parametrize("voxel_size,pc_range", [
    (FULL.inc_voxel_size, FULL.fsd.pc_range),
    ((0.8, 0.8, 0.8), (-9.6, -9.6, -2.0, 9.6, 9.6, 2.8))])
def test_incremental_mask_on_voxel_edges(voxel_size, pc_range):
    """The novel mask equals the jitted JAX function's (XLA multiplies by
    the voxel size's float32 reciprocal); on the full-width grid eager JAX,
    which divides, puts some edge points in another voxel."""
    rng = np.random.RandomState(0)
    prev = edge_points(voxel_size, pc_range, 3000, rng)
    cur = edge_points(voxel_size, pc_range, 4000, rng)
    cur[:2000] = prev[:2000]          # half of them seen before
    prev_mask = rng.rand(3000) < 0.9
    cur_mask = rng.rand(4000) < 0.9

    def fn(pp, pm, cp, cm):
        return jinc.incremental_points_mask(pp, pm, cp, cm, voxel_size,
                                            pc_range)

    ref = np.asarray(jax.jit(fn)(prev, prev_mask, cur, cur_mask))
    got = tinc.incremental_points_mask(t(prev), t(prev_mask), t(cur),
                                       t(cur_mask), voxel_size, pc_range)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < cur_mask.sum()
    jitted = np.asarray(jax.jit(lambda p, m: jinc._hash(
        p, m, voxel_size, pc_range))(cur, cur_mask))
    if voxel_size == FULL.inc_voxel_size:
        # the trap is exercised: the jitted keys differ from eager ones
        eager = np.asarray(jinc._hash(cur, cur_mask, voxel_size, pc_range))
        assert (jitted != eager).sum() > 10
    np.testing.assert_array_equal(
        tinc._hash(t(cur), t(cur_mask), voxel_size, pc_range).numpy(),
        jitted)


def test_seeds_from_output_ties_and_cap():
    """Equal scores (and the -1 of every filtered slot) keep index order,
    as ``lax.top_k``; the capacity cuts both ways."""
    rng = np.random.RandomState(1)
    n = 48
    boxes = rng.randn(n, 7).astype(np.float32)
    scores = rng.choice(np.float32([0.05, 0.3, 0.5, 0.5, 0.9]), n)
    valid = rng.rand(n) < 0.7
    labels = rng.randint(0, 3, n)
    for cap in (8, 16, 40):
        ref = jax.jit(lambda b, lab, s, v: jseeds.seeds_from_output(
            b, lab, s, v, cap, 0.1))(boxes, labels, scores, valid)
        got = tseeds.seeds_from_output(t(boxes), t(labels), t(scores),
                                       t(valid), cap, 0.1)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert 8 < (valid & (scores > 0.1)).sum() < 40


def random_seeds(rng, s, spread=6.0):
    boxes = np.concatenate([rng.uniform(-spread, spread, (s, 2)),
                            rng.uniform(-1, 0, (s, 1)),
                            rng.uniform(1, 4, (s, 3)),
                            rng.uniform(-3, 3, (s, 1))], -1)
    return tseeds.Seeds(t(boxes.astype(np.float32)),
                        t(rng.randint(0, 3, s).astype(np.int32)),
                        t(rng.rand(s).astype(np.float32)),
                        t(rng.rand(s) < 0.8))


def test_fp_insertion_and_dropout_with_jax_draws():
    """The seed augmentation fed the uniforms that the JAX functions draw
    from their keys: the FP copies, the first frame's dropout, the
    inherited decisions (a repeated box ties in IoU; the first wins) and
    the chain over a window. The JAX references come from one jitted
    function."""
    rng = np.random.RandomState(2)
    S = 16
    seeds = random_seeds(rng, S)
    prev = seeds.boxes.clone()
    prev[5] = prev[4]
    cur = random_seeds(rng, S)
    cur_boxes = cur.boxes.clone()
    cur_boxes[:10] = prev[:10] + torch.tensor([0.2, -0.1, 0, 0, 0, 0, 0.05])
    boxes = torch.stack([prev, cur_boxes, cur_boxes + 0.05])
    valid = torch.stack([seeds.valid, cur.valid, cur.valid])
    key = jax.random.PRNGKey(3)

    @jax.jit
    def reference(s, prev, cur_boxes, cur_valid, boxes, valid, key):
        r_copy, r_shift = jax.random.split(key)
        keep0 = jseeds.seed_dropout_step(None, None, None, s.boxes, s.valid,
                                         key, 0.5)
        return dict(
            fp=jseeds.seed_fp_insertion(s, key, 0.4),
            u_copy=jax.random.uniform(r_copy, (S,)),
            u_shift=jax.random.uniform(r_shift, (S, 2)),
            u_drop=jax.random.uniform(key, (S,)), keep0=keep0,
            # the next frame: moved boxes, a duplicated previous box (an
            # IoU tie)
            keep1=jseeds.seed_dropout_step(prev, s.valid, keep0, cur_boxes,
                                           cur_valid, jax.random.PRNGKey(0),
                                           0.5),
            chain=jseeds.seed_dropout_chain(boxes, valid, key, 0.5))

    ref = reference(jax_seeds(seeds), *(jnp.asarray(a.numpy()) for a in (
        prev, cur_boxes, cur.valid, boxes, valid)), key)
    got = tseeds.seed_fp_insertion(seeds, t(ref["u_copy"]),
                                   t(ref["u_shift"]), 0.4)
    assert_seeds_equal(got, ref["fp"], "fp insertion")
    assert 0 < np.asarray(ref["fp"].valid[S:]).sum() < seeds.valid.sum()

    drop_u = t(ref["u_drop"])
    keep0 = tseeds.seed_dropout_step(None, None, None, seeds.boxes,
                                     seeds.valid, drop_u, 0.5)
    np.testing.assert_array_equal(keep0.numpy(), np.asarray(ref["keep0"]))
    keep1 = tseeds.seed_dropout_step(prev, seeds.valid, keep0, cur_boxes,
                                     cur.valid, drop_u, 0.5)
    np.testing.assert_array_equal(keep1.numpy(), np.asarray(ref["keep1"]))
    got_chain = tseeds.seed_dropout_chain(boxes, valid, drop_u, 0.5)
    np.testing.assert_array_equal(got_chain.numpy(), np.asarray(ref["chain"]))
    assert (~got_chain & valid).any() and got_chain.any()


def test_crop_by_overlapping_seeds_capped_and_ground():
    """Points in overlapping enlarged boxes count in their first box only;
    the cap keeps scan order; invalid seeds crop nothing; the ground band
    goes first. The JAX references come from one jitted function."""
    rng = np.random.RandomState(4)
    S, n = 12, 3000
    seeds = random_seeds(rng, S, spread=3.0)
    pts = np.concatenate([rng.uniform(-6, 6, (n, 2)),
                          rng.uniform(-1.5, 3, (n, 1)),
                          rng.rand(n, 2)], -1).astype(np.float32)
    mask = rng.rand(n) < 0.95
    cases = ((16, None), (64, None), (16, 0.2))

    @jax.jit
    def reference(p, m, s):
        return dict(
            crops=[jseeds.crop_points_by_seeds(p, m, s, cap, (1.0, 1.0, 1.0),
                                               band) for cap, band in cases],
            inside=jax.vmap(lambda b: jseeds.box_ops.points_in_boxes(
                p[:, :3], b, (1.0, 1.0, 1.0)))(s.boxes),
            ground=jseeds.remove_ground(p, m, 0.2))

    ref = reference(pts, mask, jax_seeds(seeds))
    for (cap, band), crop in zip(cases, ref["crops"]):
        got = tseeds.crop_points_by_seeds(t(pts), t(mask), seeds, cap,
                                          (1.0, 1.0, 1.0), band)
        np.testing.assert_array_equal(got.numpy(), np.asarray(crop))
    # the cap binds and boxes overlap
    inside = np.array(ref["inside"])
    inside &= seeds.valid.numpy()[:, None] & mask[None]
    assert (inside.sum(0) > 1).sum() > 50 and (inside.sum(1) > 16).any()
    np.testing.assert_array_equal(
        tseeds.remove_ground(t(pts), t(mask), 0.2).numpy(),
        np.asarray(ref["ground"]))
    empty = tseeds.empty_seeds(S)
    assert not tseeds.crop_points_by_seeds(t(pts), t(mask), empty).any()
    assert_seeds_equal(empty, jseeds.empty_seeds(S), "empty seeds")


def test_seed_store_from_results_bin_and_round_trip(tmp_path):
    boxes = np.asarray([[1.0, 2.0, -1.0, 2.0, 4.5, 1.8, 0.3],
                        [10.0, -3.0, -0.5, 0.9, 0.9, 1.8, -1.0],
                        [-4.0, 7.0, -0.8, 0.8, 1.7, 1.6, 2.9]], np.float32)
    objs = [twb.WaymoObject(tuple(boxes[0]), 0.9, 1, "a", "seg-x", 111),
            twb.WaymoObject(tuple(boxes[1]), 0.5, 2, "b", "seg-x", 111),
            twb.WaymoObject(tuple(boxes[2]), 0.05, 4, "c", "seg-x", 111),
            twb.WaymoObject(tuple(boxes[0]), 0.7, 1, "d", "seg-y", 222)]
    path = str(tmp_path / "res.bin")
    twb.write_bin(objs, path)
    jpath = str(tmp_path / "jres.bin")
    jwb.write_bin([jwb.WaymoObject(*o.__dict__.values()) for o in objs],
                  jpath)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    for thr in (0.0, 0.1):
        store = tss.SeedStore.from_results_bin(path, 4, thr)
        ref = jss.SeedStore.from_results_bin(path, 4, thr)
        for key in (("seg-x", 111), ("seg-y", 222), ("seg-x", 999)):
            for a, b in zip(store.get(*key), ref.get(*key)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert store.get("seg-x", 111)[3].sum() == 2
    np.testing.assert_allclose(store.get("seg-y", 222)[0][0], boxes[0],
                               atol=1e-5)
    store.save(str(tmp_path / "seeds.pkl"))
    back = tss.SeedStore.load(str(tmp_path / "seeds.pkl"))
    assert pickle.dumps(back.frames) == pickle.dumps(store.frames)
    assert back.max_seeds == 4


class Frames:
    """Two sequences of distinct frames, with ``frame_meta``."""

    def __init__(self, seqs=((0, 1, 2, 3, 4), (5, 6, 7))):
        self.seqs = [list(s) for s in seqs]

    def __len__(self):
        return sum(len(s) for s in self.seqs)

    def sequences(self):
        return self.seqs

    def frame_meta(self, i):
        return ("seg-x", 111 if i % 2 else 222)

    def build_sample(self, i, rng):
        return dict(points=np.full((4, 5), i + rng.rand(), np.float32),
                    points_mask=np.arange(4) < i % 4,
                    gt_boxes=np.full((2, 7), i, np.float32),
                    gt_labels=np.full(2, i, np.int32),
                    gt_valid=np.arange(2) < i % 2)


@pytest.mark.parametrize("sequential", [True, False])
def test_sequence_loader_windows_and_carry(sequential, tmp_path):
    """The same windows, draws and carry flags as the JAX loader over two
    epochs, with offline seeds from a ``SeedStore``."""
    path = str(tmp_path / "res.bin")
    twb.write_bin([twb.WaymoObject((1.0, 2.0, -1.0, 2.0, 4.5, 1.8, 0.3),
                                   0.9, 1, "a", "seg-x", 111)], path)
    tstore = tss.SeedStore.from_results_bin(path, 4)
    jstore = jss.SeedStore.from_results_bin(path, 4)
    got = tst.SequenceLoader(Frames(), 2, seed=3, sequential=sequential,
                             seed_store=tstore)
    ref = jst.SequenceLoader(Frames(), 2, seed=3, sequential=sequential,
                             seed_store=jstore)
    carries = []
    for _ in range(6):
        a, b = next(got), next(ref)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert got.carry == ref.carry
        carries.append(got.carry)
    assert a.seed_valid.sum() == 1 and a.points.shape == (2, 4, 5)
    if sequential:
        # per epoch: windows (0, 1), (2, 3) of the first sequence, (5, 6)
        # of the second, the sequences in a random order
        assert carries.count(True) == 2 and carries.count(False) == 4
    else:
        assert not any(carries)


def test_frame_dataset_sequences(tmp_path):
    """Frames grouped by segment, in time order, as the JAX dataset."""
    root = str(tmp_path)
    info = tfd.write_synthetic_frames(root, num_frames=6, num_points=3000,
                                      num_boxes=4, seed=1, xy_range=8.0)
    assert tfd.FrameDataset(info, root).sequences() == [list(range(6))]
    infos = pickle.load(open(info, "rb"))
    for i, (seg, ts) in enumerate([("b", 5), ("a", 3), ("b", 1), ("a", 9),
                                   ("c", 0), ("b", 2)]):
        infos[i]["segment_name"] = seg
        infos[i]["timestamp"] = ts
    del infos[4]["segment_name"]
    infos[4]["point_cloud"]["segment_name"] = "c"
    mixed = os.path.join(root, "mixed.pkl")
    pickle.dump(infos, open(mixed, "wb"))
    got = tfd.FrameDataset(mixed, root).sequences()
    assert got == jfd.FrameDataset(mixed, root).sequences()
    assert got == [[1, 3], [2, 5, 0], [4]]


def test_routes_record_and_feed():
    """``Routes`` records the route of each ReLU and max reduction whose
    input takes a gradient and feeds it to another run: the second run's
    gradient follows the fed routes where its own inputs order otherwise
    (as two devices may near 0 or near a tie), its values are its own but
    at a fed ReLU's flipped inputs; the flips are counted; a fed run must
    use every mask, in shape."""
    rng = np.random.RandomState(6)
    a = torch.tensor(rng.randn(64, 8).astype(np.float32))
    b = a.clone()
    a[3, 2], b[3, 2] = 1e-7, -1e-7          # ReLU signs
    a[40, 7], b[40, 7] = -1e-7, 1e-7
    a[0, 0], a[4, 0] = 5.0, 5.0 + 1e-6      # segment 0's max, channel 0
    b[0, 0], b[4, 0] = 5.0 + 1e-6, 5.0
    a[16, 5], a[17, 5] = 6.0, 6.0 + 1e-6    # group 2's max, channel 5
    # (rows 0 and 4 are group 0's max of channel 0 as well)
    b[16, 5], b[17, 5] = 6.0 + 1e-6, 6.0
    seg = torch.arange(64) % 4
    ones = torch.ones(8, 8, dtype=torch.bool)

    def ops(x):
        return (relu(x) * 2.0, segment_max(x, seg, 4),
                masked_max(x.reshape(8, 8, 8), ones, -2))

    grads = []
    for src in (a, b):
        x = src.clone().requires_grad_(True)
        with Routes(None if src is a else rec.masks) as routes:
            outs = ops(x)
            relu(torch.ones(3))              # no gradient: not routed
        sum(o.sum() for o in outs).backward()
        grads.append(x.grad)
        if src is a:
            rec = routes
    assert len(rec.masks) == 3
    assert routes.flipped == [(0, "relu", (64, 8), 2),
                              (1, "segment_max", (64, 8), 2),
                              (2, "masked_max", (8, 8, 8), 4)]
    assert routes.flips == 8 and routes.fed == 3 * a.numel()
    assert torch.equal(grads[0], grads[1])
    plain = ops(b)
    off = (outs[0].detach() - plain[0]).abs()
    assert off.max() <= 2e-7 and int((off > 0).sum()) == 2
    assert torch.equal(outs[1].detach(), plain[1])
    assert torch.equal(outs[2].detach(), plain[2])
    with pytest.raises(RuntimeError, match="6 route masks given, 1 used"):
        with Routes(rec.masks * 2):
            relu(b.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="a mask of shape"):
        with Routes(rec.masks):
            relu(torch.zeros(3, requires_grad=True))
    assert Routes.active is None
