"""The port's sparse 3D convolution (``ops/sparse_conv.py``) held against
the JAX package's on the CPU: the dense-map and sorted-key lookups, the
neighbour table's z-triple slice path against its generic path, the
gather-GEMM, the strided output lattice (with a budget that cuts it),
conv_out's deduplicated lattice and the dense scatter. Integer outputs
equal exactly; float32 products within 2e-5 relative.

The voxels include the grid's boundary faces (x = 0, z = gz - 1) and
invalid rows whose coords lie out of range; queries reach one cell beyond
every face.

A file of at most four tests (pytest-xdist's ``--dist loadfile``; see
``test_torch_centerpoint.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from objectcentricocccompletion_tpu.ops import sparse_conv as jsc
from objectcentricocccompletion_torch.models import sparse_encoder as tse
from objectcentricocccompletion_torch.ops import sparse_conv as tsc
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

GRID = (9, 7, 6)


def voxels(seed, n_valid=90, n_invalid=14, grid=GRID):
    """Unique valid coords (the x = 0 and z = gz - 1 faces among them),
    then invalid rows with out-of-range coords."""
    rng = np.random.RandomState(seed)
    gx, gy, gz = grid
    cells = rng.permutation(gx * gy * gz)[:n_valid]
    c = np.stack(np.unravel_index(cells, grid), -1)
    c[:4, 0] = 0
    c[4:8, 2] = gz - 1
    c = np.unique(c, axis=0)[rng.permutation(len(np.unique(c, axis=0)))]
    bad = rng.randint(-2, max(grid) + 2, (n_invalid, 3))
    coords = np.concatenate([c, bad]).astype(np.int32)
    valid = np.arange(len(coords)) < len(c)
    return coords, valid


def jx(fn, *args):
    """``fn`` of the JAX package, jitted (with static shapes and offsets
    closed over), on ``args``; numpy results."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def both(coords, valid):
    return ((jnp.asarray(coords), jnp.asarray(valid)),
            (torch.tensor(coords).long(), torch.tensor(valid)))


def test_build_grid_and_lookup_dense_and_search_equal_the_jax_package():
    coords, valid = voxels(0)
    (jc, jv), (tc, tv) = both(coords, valid)
    rng = np.random.RandomState(1)
    q = np.concatenate([coords, rng.randint(-1, 10, (200, 3))]).astype(
        np.int32)
    qv = rng.rand(len(q)) < 0.9
    (jq, jqv), (tq, tqv) = both(q, qv)
    ref = jx(lambda c, v, q, qv: jsc.lookup(jsc.build_grid(c, v, GRID), q,
                                            qv), jc, jv, jq, jqv)
    assert (ref >= 0).sum() > 50 and (ref < 0).sum() > 50
    for dense in (True, False):
        g = tsc.build_grid(tc, tv, GRID, dense_index=dense)
        assert (g.dense_index is not None) == dense
        got = tsc.lookup(g, tq, tqv)
        assert got.dtype == torch.long
        np.testing.assert_array_equal(got.numpy(), ref)
    assert tsc.build_grid(tc, tv, GRID).dense_index is not None


def test_neighbor_tables_equal_the_jax_package():
    """Submanifold 3^3, the strided conv's (stride 2, padding 1) and
    conv_out's (0, 0, k) offsets: the slice path, the generic path and the
    search grid agree with JAX exactly."""
    coords, valid = voxels(2)
    (jc, jv), (tc, tv) = both(coords, valid)
    grids = [tsc.build_grid(tc, tv, GRID, dense_index=d)
             for d in (True, False)]
    out_c, out_v = jx(lambda c, v: jsc.downsample_coords(
        jsc.build_grid(c, v, GRID), 3, 2, 1, 64)[:2], jc, jv)
    (jo, jov), (to, tov) = both(out_c, out_v)

    def jtable(q, qv, offs, stride=1):
        return jx(lambda c, v, q, qv: jsc.neighbor_table(
            jsc.build_grid(c, v, GRID), q, qv, offs, stride), jc, jv, q, qv)

    scaled = np.asarray(coords) * np.asarray([1, 1, 2], np.int32)
    (js, _), (ts, _) = both(scaled.astype(np.int32), valid)
    cases = [(jc, jv, tc, tv, tsc.kernel_offsets(3), 1),
             (jo, jov, to, tov, tsc.strided_conv_offsets(3, 1), 2),
             (js, jv, ts, tv, tse.CONV_OUT_OFFSETS, 1)]
    for jq, jqv, tq, tqv, offs, stride in cases:
        assert tsc._z_triples(offs)
        ref = jtable(jq, jqv, offs, stride)
        assert (ref >= 0).any() and (ref < 0).any()
        for g in grids:
            got = tsc.neighbor_table(g, tq, tqv, offs, stride)
            np.testing.assert_array_equal(got.numpy(), ref)
    # offsets that are no z-triples take the generic path on a dense map
    offs = tsc.kernel_offsets(3)[::-1].copy()
    assert not tsc._z_triples(offs)
    np.testing.assert_array_equal(
        tsc.neighbor_table(grids[0], tc, tv, offs).numpy(),
        jtable(jc, jv, offs))


def test_sparse_conv_apply_and_downsample_equal_the_jax_package():
    coords, valid = voxels(3)
    (jc, jv), (tc, tv) = both(coords, valid)
    tg = tsc.build_grid(tc, tv, GRID)
    rng = np.random.RandomState(4)
    feats = rng.randn(len(coords), 8).astype(np.float32)
    w = (rng.randn(27, 8, 5) / np.sqrt(27 * 8)).astype(np.float32)

    def conv(c, v, f, w):
        table = jsc.neighbor_table(jsc.build_grid(c, v, GRID), c, v,
                                   jsc.kernel_offsets(3))
        return table, jsc.sparse_conv_apply(f, table, w, v)

    table, ref = jx(conv, jc, jv, feats, w)
    got = tsc.sparse_conv_apply(torch.from_numpy(feats),
                                torch.tensor(table).long(),
                                torch.from_numpy(w), tv).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())
    assert (got[~valid] == 0).all()
    # misses contribute exactly 0: an isolated voxel sees only itself
    lone = tsc.sparse_conv_apply(
        torch.ones(1, 8), torch.tensor([[-1]] * 13 + [[0]] + [[-1]] * 13),
        torch.from_numpy(w), torch.ones(1, dtype=torch.bool))
    np.testing.assert_array_equal(lone.numpy()[0], w[13].sum(0))
    # the strided lattice, whole and cut by its budget
    n = tsc.count_downsampled(tg, 3, 2, 1)
    # the output grid shape, a host tuple, comes out of a trace as it is
    jgs = []
    jax.jit(lambda c, v: jgs.append(jsc.downsample_coords(
        jsc.build_grid(c, v, GRID), 3, 2, 1, 8)[2]) or c)(jc, jv)
    for max_out in (n + 5, n - 7):
        jo, jov = jx(lambda c, v: jsc.downsample_coords(
            jsc.build_grid(c, v, GRID), 3, 2, 1, max_out)[:2], jc, jv)
        to, tov, tgs = tsc.downsample_coords(tg, 3, 2, 1, max_out)
        assert tuple(int(g) for g in jgs[0]) == tgs
        np.testing.assert_array_equal(tov.numpy(), jov)
        np.testing.assert_array_equal(to.numpy(), jo)
    assert int(tov.sum()) == n - 7 and int(jov.sum()) == n - 7


def test_conv_out_lattice_and_scatter_to_dense():
    """conv_out's lattice against a numpy reference (the keys' sorted
    unique set, cut to the budget) and its table against the JAX
    neighbour table; ``scatter_to_dense`` against the JAX package's."""
    coords, valid = voxels(5)
    (jc, jv), (tc, tv) = both(coords, valid)
    tg = tsc.build_grid(tc, tv, GRID)
    gx, gy, gz = GRID
    ogz = (gz - 3) // 2 + 1
    c = coords[valid].astype(np.int64)
    keys = set()
    for k in range(3):
        z = c[:, 2] - k
        ok = (z % 2 == 0) & (z >= 0) & (z // 2 < ogz)
        keys |= {(x, y, zz // 2) for (x, y), zz in zip(
            c[ok, :2].tolist(), z[ok].tolist())}
    want = np.asarray(sorted(keys), np.int64)
    for vmax in (len(want) + 3, len(want) - 4):
        oc, ov, table, ogs, n_occ = tse.conv_out_lattice(tg, vmax)
        assert ogs == (gx, gy, ogz) and int(n_occ) == len(want)
        m = min(vmax, len(want))
        np.testing.assert_array_equal(ov.numpy(), np.arange(vmax) < m)
        np.testing.assert_array_equal(oc.numpy()[:m], want[:m])
        ref = jx(lambda c, v, q, qv: jsc.neighbor_table(
            jsc.build_grid(c, v, GRID), q, qv, tse.CONV_OUT_OFFSETS),
            jc, jv, (oc.numpy() * [1, 1, 2]).astype(np.int32), ov.numpy())
        np.testing.assert_array_equal(table.numpy(), ref)
    feats = np.random.RandomState(6).randn(len(coords), 4).astype(
        np.float32)
    ref = jx(lambda f, c, v: jsc.scatter_to_dense(f, c, v, GRID), feats, jc,
             jv)
    got = tsc.scatter_to_dense(torch.from_numpy(feats), tc, tv, GRID)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != 0).any(axis=-1).sum() == valid.sum()
