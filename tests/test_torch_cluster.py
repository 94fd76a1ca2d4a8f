"""The port's clustering and FSD's small ops against the JAX package on the
CPU: connected components (26-neighbour and distance-linked) exactly equal,
also where 16 iterations do not converge; ``compact_labels`` with its
budget; ``points_in_boxes`` with ``extra_wlh``; the base-point coder and
its round trip; the scatter-form segment reductions with empty segments,
and a maximum shared by two rows splitting its gradient as ``jax.grad``
does. Each JAX reference is jitted: eager JAX compiles a program per op
and shape."""
import jax
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.core import boxes as jboxes
from objectcentricocccompletion_tpu.core import coder as jcoder
from objectcentricocccompletion_tpu.ops import cluster as jcl
from objectcentricocccompletion_tpu.ops import masked as jmasked
from objectcentricocccompletion_torch.core import boxes as tboxes
from objectcentricocccompletion_torch.core import coder as tcoder
from objectcentricocccompletion_torch.ops import cluster as tcl
from objectcentricocccompletion_torch.ops import masked as tmasked
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def voxel_set(seed, v=96, n_valid=80, grid=(20, 20, 3)):
    """Distinct random voxels of ``grid`` in the first ``n_valid`` of ``v``
    slots, then padding."""
    rng = np.random.RandomState(seed)
    cells = rng.choice(int(np.prod(grid)), n_valid, replace=False)
    coords = np.zeros((v, 3), np.int32)
    coords[:n_valid] = np.stack(np.unravel_index(cells, grid), -1)
    return coords, np.arange(v) < n_valid, grid


@pytest.mark.parametrize("seed", [0, 1])
def test_connected_components_equal_the_jax_package(seed):
    coords, valid, grid = voxel_set(seed)
    ref = np.asarray(jax.jit(jcl.connected_components, static_argnums=2)(
        coords, valid, grid))
    got = tcl.connected_components(torch.from_numpy(coords),
                                   torch.from_numpy(valid), grid)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 2 <= len(np.unique(ref[valid])) < valid.sum()

    # a row of 200 voxels whose slots lie in random order along it: 16
    # rounds of propagation and pointer jumping do not converge, and both
    # keep the same partial labels
    snake = np.zeros((200, 3), np.int32)
    snake[:, 0] = np.random.RandomState(seed).permutation(200)
    ok = np.ones(200, bool)
    ref = np.asarray(jax.jit(jcl.connected_components, static_argnums=2)(
        snake, ok, (200, 1, 1)))
    got = tcl.connected_components(torch.from_numpy(snake),
                                   torch.from_numpy(ok), (200, 1, 1))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_components_dist_equal_the_jax_package(seed):
    coords, valid, grid = voxel_set(seed, grid=(16, 16, 1), n_valid=70,
                                    v=80)
    rng = np.random.RandomState(seed + 10)
    vsize = 0.2
    centers = ((coords + rng.uniform(0, 1, coords.shape)) * vsize
               ).astype(np.float32)
    for dist, r in ((0.25, 2), (0.4, 3)):
        ref = np.asarray(jax.jit(
            jcl.connected_components_dist, static_argnums=(2, 4, 5))(
                coords, valid, grid, centers, dist, r))
        got = tcl.connected_components_dist(
            torch.from_numpy(coords), torch.from_numpy(valid), grid,
            torch.from_numpy(centers), dist, window_radius=r)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert 2 <= len(np.unique(ref[valid])) < valid.sum()
        # the budget keeps the components of the smallest ids
        for budget in (4, 200):
            rl, rn = jax.jit(jcl.compact_labels, static_argnums=1)(
                ref, budget)
            gl, gn = tcl.compact_labels(got, budget)
            np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
            assert int(gn) == int(rn)


def test_points_in_boxes_and_point_coder_equal_the_jax_package():
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.uniform(-5, 5, (6, 3)),
                            rng.uniform(0.5, 4, (6, 3)),
                            rng.uniform(-np.pi, np.pi, (6, 1))],
                           -1).astype(np.float32)
    pts = rng.uniform(-7, 7, (500, 3)).astype(np.float32)
    for extra in ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5)):
        ref = np.asarray(jax.jit(jax.vmap(lambda b: jboxes.points_in_boxes(
            pts, b, extra)))(boxes))
        got = tboxes.points_in_boxes(torch.from_numpy(pts),
                                     torch.from_numpy(boxes), extra)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert 0 < ref.sum() < ref.size
    base = pts[:6]
    enc = tcoder.point_encode(torch.from_numpy(boxes),
                              torch.from_numpy(base))
    np.testing.assert_allclose(enc.numpy(), np.asarray(
        jax.jit(jcoder.point_encode)(boxes, base)), rtol=1e-6, atol=1e-6)
    dec = tcoder.point_decode(enc, torch.from_numpy(base))
    np.testing.assert_allclose(dec.numpy(), np.asarray(
        jax.jit(jcoder.point_decode)(np.asarray(enc), base)), rtol=1e-6,
        atol=1e-6)
    wrapped = np.arctan2(np.sin(boxes[:, 6]), np.cos(boxes[:, 6]))
    np.testing.assert_allclose(dec[:, :6].numpy(), boxes[:, :6], atol=1e-5)
    np.testing.assert_allclose(dec[:, 6].numpy(), wrapped, atol=1e-5)
    # sin = cos = 0: yaw 0 with a finite gradient, as in the JAX package
    reg = torch.zeros(1, 8, requires_grad=True)
    tcoder.point_decode(reg, torch.zeros(1, 3))[0, 6].backward()
    assert torch.isfinite(reg.grad).all()


def test_segment_reductions_equal_the_jax_package():
    rng = np.random.RandomState(0)
    x = rng.randn(40, 5).astype(np.float32)
    seg = rng.randint(0, 7, 40)
    seg[seg == 3] = 4                      # segment 3 stays empty
    tx, tseg = torch.from_numpy(x), torch.from_numpy(seg)
    for name in ("segment_sum", "segment_mean", "segment_max"):
        ref = np.asarray(jax.jit(getattr(jmasked, name),
                                 static_argnums=2)(x, seg, 8))
        got = getattr(tmasked, name)(tx, tseg, 8)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        assert (ref[3] == 0).all() and (ref[7] == 0).all()
    # a maximum two rows share splits its gradient between them
    x = np.float32([[1.0], [1.0], [0.5], [2.0]])
    seg = np.int32([0, 0, 0, 1])
    ref = np.asarray(jax.jit(jax.grad(lambda a: jmasked.segment_max(
        a, seg, 2).sum()))(x))
    tx = torch.from_numpy(x).requires_grad_()
    tmasked.segment_max(tx, torch.from_numpy(seg).long(), 2).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), ref)
    np.testing.assert_array_equal(ref[:, 0], [0.5, 0.5, 0.0, 1.0])
    # gather_rows: zeros where not valid, no gradient to the rows there
    rows = torch.randn(5, 3, requires_grad=True)
    idx = torch.tensor([4, 0, -1, 4])
    out = tmasked.gather_rows(rows, idx, idx >= 0)
    assert torch.equal(out[2], torch.zeros(3))
    out.sum().backward()
    np.testing.assert_array_equal(rows.grad[:, 0].numpy(), [1, 0, 0, 0, 2])
