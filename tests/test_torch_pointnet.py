"""The port's PointNet++ primitives (``ops/pointnet.py``) held against the
JAX package on the CPU, on numpy inputs made from a seed.

Every pick (nearest-neighbour indices, ball memberships, furthest point
samples) must equal JAX's exactly, equal distances included: duplicate
points and queries with fewer valid points than k, whose masked points all
tie at 1e10. Distances within 1e-6 relative (the same float32 operations
in the same order); the interpolation and the score assembly, values and
gradients, within 1e-5 relative plus 2e-5 absolute (sums of O(10) terms in
another order).

A file of at most four tests (pytest-xdist's ``--dist loadfile`` hands out
the files with the most tests first)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.ops import pointnet as jpn
from objectcentricocccompletion_torch.ops import pointnet as pn
from objectcentricocccompletion_torch.ops.routes import Routes
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

RTOL = 1e-6
# the einsum's and the interpolation's sums of O(10) values, summed in
# another order
SUM_ATOL = 2e-5


def _cloud(n=300, seed=0, valid=0.8):
    """Points with exact duplicates (a block repeated) and a mask."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = n // 8
    pts[n - d:] = pts[:d]                         # exact duplicates
    mask = rng.rand(n) < valid
    return pts, mask


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_knn_and_ball_query_match():
    """knn and ball_query, dense and sparse; ``sparse``: 6 valid points for
    k = 16, so every query gets masked points tied at 1e10 (index order,
    as lax.top_k)."""
    for case in ("dense", "sparse"):
        _check_knn_and_ball_query(case)


def _check_knn_and_ball_query(case):
    pts, mask = _cloud()
    if case == "sparse":
        mask[:] = False
        mask[[3, 37, 41, 100, 263, 299]] = True   # 263 duplicates 0
    q = np.concatenate([pts[:20], _cloud(30, seed=1)[0]])
    k, r = 16, 0.6
    ref = jax.jit(lambda q, p, m: (jpn.knn(q, p, m, k),
                                   jpn.ball_query(q, p, m, r, k),
                                   jpn.square_distance(q, p)))(q, pts, mask)
    (ridx, rdist), (bidx, bok), rd2 = (jax.tree_util.tree_map(np.asarray, x)
                                       for x in ref)
    tq, tp, tm = _t(q, pts, mask)
    idx, dist = pn.knn(tq, tp, tm, k)
    np.testing.assert_array_equal(idx.numpy(), ridx)
    np.testing.assert_allclose(dist.numpy(), rdist, rtol=RTOL)
    gidx, gok = pn.ball_query(tq, tp, tm, r, k)
    np.testing.assert_array_equal(gidx.numpy(), bidx)
    np.testing.assert_array_equal(gok.numpy(), bok)
    np.testing.assert_allclose(pn.square_distance(tq, tp).numpy(), rd2,
                               rtol=RTOL)
    if case == "sparse":
        assert (rdist[:, 6:] == 1e10).all() and not bok[:, 6:].any()
    else:
        assert bok.any(-1).mean() > 0.9 and not bok.all()


def test_furthest_point_sample_and_gathers_match():
    """FPS over a cloud with duplicates, over one with fewer valid points
    than samples (the first valid point repeats once they run out, as in
    JAX), and over none valid; gather_points and group_points."""
    pts, mask = _cloud()
    few = np.zeros_like(mask)
    few[[5, 17, 200]] = True
    fps = jax.jit(jpn.furthest_point_sample, static_argnums=2)
    for m, n in ((mask, 64), (few, 8), (np.zeros_like(mask), 4)):
        ref = np.asarray(fps(pts, m, n))
        got = pn.furthest_point_sample(*_t(pts, m), n)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert sorted(set(ref)) == [0]
    feats = np.random.RandomState(2).randn(len(pts), 5).astype(np.float32)
    feats[:, :3] = pts
    idx = np.random.RandomState(3).randint(0, len(pts), (12, 6))
    centers = pts[:12]
    rg, rc = jax.jit(lambda f, i, c: (jpn.gather_points(f, i),
                                      jpn.group_points(f, i, c)))(
        feats, idx, centers)
    tf, ti, tc = _t(feats, idx, centers)
    np.testing.assert_array_equal(pn.gather_points(tf, ti).numpy(), rg)
    np.testing.assert_allclose(pn.group_points(tf, ti, tc).numpy(), rc,
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_array_equal(pn.group_points(tf, ti).numpy(),
                                  np.asarray(rg))


def test_interpolation_and_score_assembly_match():
    """three_interpolate (a query on a support point, masked support) and
    assign_score_withk in each aggregation, values and gradients."""
    pts, mask = _cloud(200)
    on = 30 + np.nonzero(mask[30:170])[0][:5]     # valid, not duplicated
    q = np.concatenate([pts[on], _cloud(40, seed=4)[0]])
    rng = np.random.RandomState(5)
    feats = rng.randn(200, 7).astype(np.float32)
    Q, k, M, C = 45, 6, 4, 5
    scores = rng.rand(Q, k, M).astype(np.float32)
    pf = rng.randn(200, M, C).astype(np.float32)
    cf = rng.randn(200, M, C).astype(np.float32)
    kidx = rng.randint(0, 200, (Q, k))
    aggs = ("sum", "avg", "max", "none")

    def ref_fn(feats, scores, pf):
        out = [jpn.three_interpolate(q, pts, mask, feats)]
        out += [jpn.assign_score_withk(scores, pf, cf, kidx, a)
                for a in aggs]
        return out, sum(jnp.sum(jnp.sin(o)) for o in out)

    # one jitted reference: eager JAX compiles a program per op and shape
    ref_out, ref_grads = jax.jit(lambda *a: (ref_fn(*a)[0], jax.grad(
        lambda *b: ref_fn(*b)[1], argnums=(0, 1, 2))(*a)))(feats, scores, pf)
    tfe, tsc, tpf = (x.requires_grad_() for x in _t(feats, scores, pf))
    tq, tp, tm, tcf, tk = _t(q, pts, mask, cf, kidx)
    out = [pn.three_interpolate(tq, tp, tm, tfe)]
    out += [pn.assign_score_withk(tsc, tpf, tcf, tk, a) for a in aggs]
    for o, r in zip(out, ref_out):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=SUM_ATOL)
    sum(torch.sin(o).sum() for o in out).backward()
    for g, r in zip((tfe, tsc, tpf), ref_grads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r),
                                   rtol=1e-5, atol=SUM_ATOL)
    np.testing.assert_allclose(out[0][:5].detach().numpy(), feats[on],
                               atol=1e-3)   # a query on a support point


def test_picks_record_and_feed():
    """Picks go through ``Routes``: recorded on one run and fed to another,
    the fed run takes them, counts its own differing elements in
    ``flips``, and a count mismatch raises."""
    pts, mask = _cloud()
    tp, tm = _t(pts, mask)
    with Routes() as rec:
        idx = pn.furthest_point_sample(tp, tm, 32)
        nidx, ok = pn.ball_query(tp[idx], tp, tm, 0.5, 8)
    assert [p.shape for p in rec.masks] == [(32,), (32, 8), (32, 8)]
    moved = tp + 0.3 * torch.from_numpy(
        np.random.RandomState(7).randn(*pts.shape).astype(np.float32))
    with Routes(rec.masks) as fed:
        idx2 = pn.furthest_point_sample(moved, tm, 32)
        nidx2, ok2 = pn.ball_query(moved[idx2], moved, tm, 0.5, 8)
    assert torch.equal(idx2, idx) and torch.equal(ok2, ok)
    assert torch.equal(nidx2, nidx)
    assert fed.flips > 0 and fed.fed == 32 + 2 * 32 * 8
    assert fed.flips == sum(n for *_, n in fed.flipped)
    assert [k for _, k, _, _ in fed.flipped][0] == "fps"
    with Routes(rec.masks) as same:
        pn.furthest_point_sample(tp, tm, 32)
        pn.ball_query(tp[idx], tp, tm, 0.5, 8)
    assert same.flips == 0
    with pytest.raises(RuntimeError, match="route masks given"):
        with Routes(rec.masks):
            pn.furthest_point_sample(tp, tm, 32)
