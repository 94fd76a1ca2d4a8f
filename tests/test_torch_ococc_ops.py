"""The port's OcOccNet geometry and point-layout ops held against the JAX
package on the CPU: ``core/boxes.py``, ``core/coder.py``,
``ops/roi_pool.py``, ``ops/masked.py`` and ``ops/packed.py``.

Inputs are made from a numpy seed and go through the JAX function (jitted,
as the model runs it) and the port's. Index outputs (masks, orders,
segment ids) must be equal exactly; geometry within 1e-5 (float32
elementwise arithmetic in another order).
"""
import jax
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.core import boxes as jboxes
from objectcentricocccompletion_tpu.core import coder as jcoder
from objectcentricocccompletion_tpu.ops import masked as jmasked
from objectcentricocccompletion_tpu.ops import packed as jpk
from objectcentricocccompletion_tpu.ops import roi_pool as jrp
from objectcentricocccompletion_torch.core import boxes as tboxes
from objectcentricocccompletion_torch.core import coder as tcoder
from objectcentricocccompletion_torch.ops import masked as tmasked
from objectcentricocccompletion_torch.ops import packed as tpk
from objectcentricocccompletion_torch.ops import roi_pool as troi

GEOM_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol=GEOM_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=0)


def _boxes(rng, shape, lo=-50, hi=50):
    return np.concatenate([rng.uniform(lo, hi, shape + (3,)),
                           rng.uniform(0.5, 5, shape + (3,)),
                           rng.uniform(-2 * np.pi, 2 * np.pi, shape + (1,))],
                          -1).astype(np.float32)


def test_box_geometry_matches():
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, (3, 5))
    boxes[0, 0, 6] = 0.0                            # a zero-yaw box
    pts = rng.uniform(-60, 60, (3, 5, 40, 3)).astype(np.float32)
    ang = rng.uniform(-7, 7, (3, 5, 40)).astype(np.float32)
    # a point at the gravity centre
    pts[0, 0, 0] = boxes[0, 0, :3] + [0, 0, 0.5 * boxes[0, 0, 5]]

    @jax.jit
    def ref(pts, ang, boxes):
        loc = jboxes.box_local_coords(pts, boxes)
        return (jboxes.rotate_z(pts, ang), jboxes.gravity_center(boxes), loc,
                jboxes.local_to_global(loc, boxes))

    rot, ctr, loc, back_ref = ref(pts, ang, boxes)
    _close(tboxes.rotate_z(_t(pts), _t(ang)), rot)
    _close(tboxes.gravity_center(_t(boxes)), ctr)
    got = tboxes.box_local_coords(_t(pts), _t(boxes))
    _close(got, loc)
    assert got[0, 0, 0].abs().max() == 0.0
    back = tboxes.local_to_global(got, _t(boxes))
    _close(back, back_ref, atol=2e-5)
    # the round trip returns the points (values up to ~110 m: 2e-5)
    _close(back, pts, atol=2e-5)


def test_coder_roi_targets_match():
    rng = np.random.RandomState(1)
    rois = _boxes(rng, (4, 16))
    gt = rois + np.concatenate([rng.uniform(-0.5, 0.5, (4, 16, 3)),
                                rng.uniform(-0.3, 0.3, (4, 16, 3)),
                                rng.uniform(-4, 4, (4, 16, 1))],
                               -1).astype(np.float32)
    # headings on the flip boundaries and beyond 2 pi
    rel = np.array([0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi, 1.5 * np.pi,
                    7.0, -7.0, 3 * np.pi / 4], np.float32)
    _close(tcoder.canonical_yaw_target(_t(rel)),
           jax.jit(jcoder.canonical_yaw_target)(rel))
    ref = jax.jit(jcoder.encode_roi_targets)(rois, gt)
    got = tcoder.encode_roi_targets(_t(rois), _t(gt))
    _close(got, ref)
    dec_ref = jax.jit(jcoder.decode_from_rois)(rois, ref)
    _close(tcoder.decode_from_rois(_t(rois), _t(ref)), dec_ref)
    # encode -> decode gives the GT box back, its heading up to a flip by
    # pi and a turn by 2 pi (centres up to ~55 m: 2e-5)
    back = tcoder.decode_from_rois(_t(rois), got).numpy()
    _close(torch.from_numpy(back[..., :6]), gt[..., :6], atol=2e-5)
    dyaw = np.mod(back[..., 6] - gt[..., 6] + np.pi / 2, np.pi) - np.pi / 2
    assert np.abs(dyaw).max() < 1e-4


def _tracklets(rng, B, L, P, empty_frame=True, empty_tracklet=False):
    """Points near each frame's RoI (about a third outside its margin)."""
    rois = _boxes(rng, (B, L), -30, 30)
    local = rng.uniform(-0.8, 0.8, (B, L, P, 3)) * rois[:, :, None, 3:6]
    pts = tboxes.local_to_global(_t(local.astype(np.float32)),
                                 _t(rois)).numpy()
    mask = rng.rand(B, L, P) < 0.8
    if empty_frame:
        mask[0, 1] = False
    if empty_tracklet:
        mask[-1] = False
    return pts.astype(np.float32), mask, rois


@pytest.mark.parametrize("empty_tracklet", [False, True])
def test_roi_pool_matches(empty_tracklet):
    rng = np.random.RandomState(2)
    pts, mask, rois = _tracklets(rng, 3, 6, 50,
                                 empty_tracklet=empty_tracklet)
    ref = jax.jit(lambda p, m, r: jrp.roi_pool(p, m, r, (0.5, 0.5, 0.5)))(
        pts, mask, rois)
    got = troi.roi_pool(_t(pts), _t(mask), _t(rois), (0.5, 0.5, 0.5))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.is_in_margin.numpy(),
                                  np.asarray(ref.is_in_margin))
    for name in ("local_xyz", "boundary_offset", "rel_xyz"):
        _close(getattr(got, name), getattr(ref, name))
    assert 0 < got.mask.sum() < mask.sum()     # some points fall outside
    assert got.is_in_margin.sum() > 0
    if empty_tracklet:
        assert not got.mask[-1].any()


def test_quantize_to_voxel_centers_matches_the_jitted_function():
    """The jitted JAX function multiplies by the float32 reciprocal of the
    voxel size, which moves points that lie on a cell boundary (the eager
    function's division does not); the port does the same, so no point
    changes cell (a changed cell is a 0.2 m error, far above the bar)."""
    rng = np.random.RandomState(3)
    pts, mask, rois = _tracklets(rng, 4, 8, 256)
    pool = troi.roi_pool(_t(pts), _t(mask), _t(rois))
    local = pool.local_xyz.numpy()
    sizes = rois[..., 3:6]
    # half the points on cell boundaries
    k = rng.randint(0, 20, local[:, :, :128].shape).astype(np.float32)
    local[:, :, :128] = -0.5 * sizes[:, :, None] + k * np.float32(0.2)
    ref = jax.jit(lambda a, b: jrp.quantize_to_voxel_centers(a, b, 0.2))(
        local, sizes)
    _close(troi.quantize_to_voxel_centers(_t(local), _t(sizes), 0.2), ref)
    flat_sizes = np.broadcast_to(sizes[:, :, None], local.shape).reshape(
        4, -1, 3)
    flat_local = local.reshape(4, -1, 3)
    ref = jax.jit(lambda a, b: jrp.quantize_to_voxel_centers_aligned(
        a, b, 0.2))(flat_local, flat_sizes)
    _close(troi.quantize_to_voxel_centers_aligned(
        _t(flat_local), _t(np.ascontiguousarray(flat_sizes)), 0.2), ref)


def test_masked_reductions_empty_group_gives_zero():
    rng = np.random.RandomState(4)
    x = rng.randn(5, 7, 4).astype(np.float32)
    m = rng.rand(5, 7) < 0.5
    m[2] = False                                    # an empty group
    ref = jax.jit(lambda x, m: (jmasked.masked_max(x, m, axis=-2),
                                jmasked.masked_mean(x, m, axis=-2)))(x, m)
    for fn, r in zip((tmasked.masked_max, tmasked.masked_mean), ref):
        got = fn(_t(x), _t(m), -2)
        _close(got, r, atol=1e-6)
        assert torch.equal(got[2], torch.zeros(4))


def _pack_mask(seed, B, L, P, empty_frame=True, empty_tracklet=False):
    """Per-frame valid counts from 0 to P (points first, then padding with
    holes), so dense frames overflow a small budget."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, P + 1, (B, L))
    mask = np.arange(P)[None, None] < counts[..., None]
    mask &= rng.rand(B, L, P) < 0.9
    if empty_frame:
        mask[0, 1] = False
    if empty_tracklet:
        mask[-1] = False
    return mask


# budgets that bind (a waterfill cap of a few points, one that binds some
# samples only) and one that holds every point
@pytest.mark.parametrize("budget", [40, 55, 400])
def test_pack_groups_indices_exact(budget):
    mask = _pack_mask(5, 3, 6, 24, empty_tracklet=True)
    ref = jax.jit(lambda m: jpk.pack_groups(m, budget))(mask)
    got = tpk.pack_groups(_t(mask), budget)
    for name in ("order", "seg_ids", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert got.block_seg is None
    assert not got.valid[-1].any()                 # the empty tracklet
    if budget == 400:
        assert int(got.valid.sum()) == int(mask.sum())


@pytest.mark.parametrize("budget", [20, 55, 1000])
def test_waterfill_cap_exact(budget):
    mask = _pack_mask(6, 4, 5, 30)
    ref = jax.jit(lambda m: jpk.waterfill_cap(m, budget))(mask)
    got = tpk.waterfill_cap(_t(mask), budget)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.sum((1, 2)) <= budget).all()


# quantum 16 with a budget that binds (waterfill of the aligned footprint)
# and one that holds every frame; quantum 8
@pytest.mark.parametrize("budget,quantum", [(128, 16), (512, 16), (96, 8)])
def test_pack_groups_aligned_indices_exact(budget, quantum):
    mask = _pack_mask(7, 3, 8, 40, empty_tracklet=True)
    ref = jax.jit(lambda m: jpk.pack_groups_aligned(m, budget, quantum))(
        mask)
    got = tpk.pack_groups_aligned(_t(mask), budget, quantum)
    for name in ("order", "seg_ids", "valid", "block_seg"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    # every block lies in one frame
    seg = got.seg_ids.reshape(3, budget // quantum, quantum)
    filled = got.valid.reshape(seg.shape)
    assert ((seg == got.block_seg[..., None]) | ~filled).all()
    assert not got.valid[-1].any()


def test_pack_groups_aligned_rejects_a_budget_too_small():
    mask = torch.ones(1, 8, 4, dtype=torch.bool)
    with pytest.raises(ValueError):
        tpk.pack_groups_aligned(mask, 100, 16)     # not a multiple
    with pytest.raises(ValueError):
        tpk.pack_groups_aligned(mask, 112, 16)     # < 8 frames x 16


@pytest.mark.parametrize("quantum", [0, 16])
def test_segment_ops_match(quantum):
    """Reductions and broadcasts of both packed forms on the same packing;
    an empty frame and an empty tracklet give 0."""
    B, L, P, C, budget = 3, 8, 40, 5, 128
    mask = _pack_mask(8, B, L, P, empty_tracklet=True)
    rng = np.random.RandomState(9)
    x = rng.randn(B, budget, C).astype(np.float32)
    g = rng.randn(B, L, C).astype(np.float32)
    rows = rng.randn(B, L, P, C).astype(np.float32)

    @jax.jit
    def ref(mask, x, g, rows):
        if quantum:
            p = jpk.pack_groups_aligned(mask, budget, quantum)
            red = (jpk.segment_max_blocked(x, p.valid, p.block_seg, L),
                   jpk.segment_mean_blocked(x, p.valid, p.block_seg, L))
            back = jpk.broadcast_back_blocked(g, p.block_seg, budget)
        else:
            p = jpk.pack_groups(mask, budget)
            red = (jpk.segment_max(x, p.seg_ids, L),
                   jpk.segment_mean(x, p.seg_ids, L),
                   jpk.segment_sum(x, p.seg_ids, L))
            back = jpk.broadcast_back(g, p.seg_ids)
        return (p, red, back, jpk.segment_any(p.seg_ids, L),
                jpk.pack_rows(rows, p.order), jpk.pack_rows(mask, p.order))

    p, red, back, any_ref, rows_ref, mask_ref = ref(mask, x, g, rows)
    ts, tv = _t(p.seg_ids).long(), _t(p.valid)
    if quantum:
        tb = _t(p.block_seg).long()
        got = (tpk.segment_max_blocked(_t(x), tv, tb, L),
               tpk.segment_mean_blocked(_t(x), tv, tb, L))
        got_back = tpk.broadcast_back_blocked(_t(g), tb, budget)
    else:
        got = (tpk.segment_max(_t(x), ts, L), tpk.segment_mean(_t(x), ts, L),
               tpk.segment_sum(_t(x), ts, L))
        got_back = tpk.broadcast_back(_t(g), ts)
    for a, b in zip(got, red):
        # float32 sums in another order: 1e-5
        _close(a, b)
        assert torch.equal(a[-1], torch.zeros(L, C))     # empty tracklet
        assert torch.equal(a[0, 1], torch.zeros(C))      # empty frame
    np.testing.assert_array_equal(got_back.numpy(), np.asarray(back))
    np.testing.assert_array_equal(tpk.segment_any(ts, L).numpy(),
                                  np.asarray(any_ref))
    order = _t(p.order).long()
    np.testing.assert_array_equal(tpk.pack_rows(_t(rows), order).numpy(),
                                  np.asarray(rows_ref))
    np.testing.assert_array_equal(tpk.pack_rows(_t(mask), order).numpy(),
                                  np.asarray(mask_ref))
