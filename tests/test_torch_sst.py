"""The port's SST inference path held against the JAX package on the CPU.

Inputs are made from a numpy seed and go through the JAX function and its
counterpart in ``objectcentricocccompletion_torch``; weights cross over
through ``convert.py``. Index outputs (voxel coords, point-to-voxel maps,
window slots and ranks) must be equal exactly; every float tolerance is
stated where it is used. One JAX parameter tree (shapes from
the converter's tree of the port's model, values from numpy) and one jitted JAX apply are shared
by the whole file. The window partition, the non-square detector, the
anchor-head decode and the converter's round trip are in
``test_torch_sst_partition*.py`` and ``test_torch_sst_heads.py`` (files of
at most four tests: xdist's ``loadfile`` starts large files first).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.core import coder as jcoder
from objectcentricocccompletion_tpu.models import anchor_head as jah
from objectcentricocccompletion_tpu.models import sst as jsst
from objectcentricocccompletion_tpu.models import sst_detector as jdet
from objectcentricocccompletion_tpu.models.vfe import DynamicVFE as JVFE
from objectcentricocccompletion_tpu.ops import voxelize as jvx
from objectcentricocccompletion_tpu.ops import window as jwin
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.core import coder as tcoder
from objectcentricocccompletion_torch.data.synthetic import synth_frame
from objectcentricocccompletion_torch.evalx.detector_eval import (
    make_predict_fn)
from objectcentricocccompletion_torch.models import anchor_head as tah
from objectcentricocccompletion_torch.models import sst as tsst
from objectcentricocccompletion_torch.models import sst_detector as tdet
from objectcentricocccompletion_torch.models.layers import (_gelu_exact,
                                                            dense,
                                                            layer_norm)
from objectcentricocccompletion_torch.models.vfe import DynamicVFE as TVFE
from objectcentricocccompletion_torch.ops import voxelize as tvx
from objectcentricocccompletion_torch.ops import window as twin
from objectcentricocccompletion_torch.ops.window_attention import (
    window_attention, window_attention_plain)
from objectcentricocccompletion_torch.utils.device import resolve_device

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
from bench_detectors import synth_frame as jax_synth_frame  # noqa: E402
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

FULL = jdet.SSTDetectorConfig()
TINY = jdet.tiny_sst_detector_config()


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_params(shapes, seed):
    """flax-shaped params from numpy: lecun-scaled kernels, norm scales
    near 1, small biases."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _frame(cfg, num_real, seed):
    s = cfg.sst
    points, mask, *_ = synth_frame(s.max_points, s.pc_range,
                                   num_real=num_real, seed=seed)
    return points, mask


def _torch_config(jcfg):
    """The port's config with the same field values as a JAX one."""
    return tdet.SSTDetectorConfig(
        sst=tsst.SSTConfig(**dataclasses.asdict(jcfg.sst)),
        anchors=tah.AnchorConfig(**dataclasses.asdict(jcfg.anchors)),
        num_classes=jcfg.num_classes, neck_channels=jcfg.neck_channels,
        max_gt=jcfg.max_gt)


def _param_tree(jcfg):
    """The flax tree of ``jcfg``'s detector as ``convert`` writes it for
    the port's (its shapes without tracing the JAX ``init``, which costs
    seconds)."""
    return convert.state_dict_to_flax(tdet.SSTDetector(
        _torch_config(jcfg), device="cpu").state_dict())


def _detector_pair(jcfg, num_real, seed):
    """numpy params, the jitted JAX forward, and the port's model loaded
    with the converted params."""
    points, mask = _frame(jcfg, num_real, seed=seed)
    model = jdet.SSTDetector(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    _random_params(_param_tree(jcfg), seed))
    apply = jax.jit(lambda p, a, b: model.apply({"params": p}, a, b))
    out = apply(params, points, mask)
    ref = {k: np.asarray(out[k]) for k in ("cls", "reg", "dir")}
    tmodel = tdet.SSTDetector(_torch_config(jcfg), device="cpu")
    tmodel.load_state_dict(convert.flax_to_state_dict(params))
    return dict(points=points, mask=mask, params=params, ref=ref,
                tmodel=tmodel)


def _check_forward(pair, hw):
    with torch.no_grad():
        out = pair["tmodel"](_t(pair["points"]), _t(pair["mask"]))
    for k in ("cls", "reg", "dir"):
        assert out[k].dtype == torch.float32
        assert out[k].shape == pair["ref"][k].shape
        # the fp32 bar of tests/test_pallas_attention.py: 2e-4
        np.testing.assert_allclose(out[k].numpy(), pair["ref"][k],
                                   atol=2e-4, rtol=0)
    assert out["bev_hw"] == hw


@pytest.fixture(scope="module")
def tiny():
    return _detector_pair(TINY, 1800, seed=3)


def test_configs_match_the_jax_package():
    for jc, tc in ((jdet.SSTDetectorConfig(), tdet.SSTDetectorConfig()),
                   (TINY, tdet.tiny_sst_detector_config())):
        # the port's own field: the points' width, which the JAX package
        # reads off the input (5 columns without sweeps)
        port = dataclasses.asdict(tc)
        assert port["sst"].pop("point_dim") == 5
        assert dataclasses.asdict(jc) == port
        assert jc.sst.grid_shape == tc.sst.grid_shape
        assert jc.sst.capacity == tc.sst.capacity
        assert jc.sst.small_windows_budget == tc.sst.small_windows_budget
        assert jc.sst.large_windows_budget == tc.sst.large_windows_budget
    assert dataclasses.asdict(jah.waymo_3class_anchor_config()) == \
        dataclasses.asdict(tah.waymo_3class_anchor_config())


@pytest.mark.parametrize("num_real,seed", [(150000, 0), (20000, 1)])
def test_synth_frame_equals_bench_detectors(num_real, seed):
    s = FULL.sst
    ours = synth_frame(s.max_points, s.pc_range, num_real=num_real,
                       seed=seed)
    ref = jax_synth_frame(s.max_points, s.pc_range, num_real=num_real,
                          seed=seed)
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _voxelize_both(cfg, points, mask):
    s = cfg.sst
    j = jax.jit(lambda p, m: jvx.voxelize(p, m, s.voxel_size, s.pc_range,
                                          s.max_voxels))(points, mask)
    t = tvx.voxelize(_t(points), _t(mask), s.voxel_size, s.pc_range,
                     s.max_voxels)
    return j, t


# the dense full-width frame has far more voxels than max_voxels (20000),
# so voxels past the buffer are dropped; the tiny frame fills 512 of 576
@pytest.mark.parametrize("which", ["full_dense", "full_sparse", "tiny"])
def test_voxelize_indices_exact(which):
    cfg, num_real = {"full_dense": (FULL, 150000),
                     "full_sparse": (FULL, 20000),
                     "tiny": (TINY, 1800)}[which]
    points, mask = _frame(cfg, num_real, seed=0)
    j, t = _voxelize_both(cfg, points, mask)
    for name in ("coords", "voxel_valid", "point2voxel", "point_valid",
                 "num_voxels"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    if which == "full_dense":
        assert int(t.num_voxels) > cfg.sst.max_voxels


def test_scatter_gather_match():
    rng = np.random.RandomState(0)
    n, v, c = 400, 50, 6
    feats = rng.randn(n, c).astype(np.float32)
    p2v = rng.randint(-1, v, n).astype(np.int32)
    p2v[p2v == 7] = -1            # voxel 7 stays empty
    for mode in ("max", "mean", "sum"):
        ref = np.asarray(jvx.scatter_to_voxels(jnp.asarray(feats),
                                               jnp.asarray(p2v), v, mode))
        got = tvx.scatter_to_voxels(_t(feats), _t(p2v).long(), v, mode)
        # float32 sums in another order: atol 1e-5
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    vf = rng.randn(v, c).astype(np.float32)
    ref = np.asarray(jvx.gather_from_voxels(jnp.asarray(vf),
                                            jnp.asarray(p2v)))
    np.testing.assert_array_equal(
        tvx.gather_from_voxels(_t(vf), _t(p2v).long()).numpy(), ref)


# (max_windows, capacity, small_capacity, max_small, max_large): the
# production budgets, then budgets small enough that windows and tokens
# are dropped at both levels
PARTITION_CASES = [(3200, 144, 32, 3200, 800), (40, 144, 32, 25, 6),
                   (300, 20, 8, 120, 30)]


def check_partition_and_split(case, shifted):
    """Window partition, occupancy split and flat <-> window moves of a
    full-width frame, index for index (``test_torch_sst_partition*.py``)."""
    mw, cap, small, max_small, max_large = case
    s = FULL.sst
    points, mask = _frame(FULL, 150000, seed=0)
    jv, tv = _voxelize_both(FULL, points, mask)
    gs = s.grid_shape

    @jax.jit
    def jax_part(coords, valid):
        p = jwin.partition(coords, valid, gs, s.window_shape, shifted, mw,
                           cap)
        return (p,) + tuple(jwin.split_by_occupancy(p, mw, small, max_small,
                                                    max_large))

    jparts = jax_part(jv.coords, jv.voxel_valid)
    p = twin.partition(tv.coords, tv.voxel_valid, gs, s.window_shape,
                       shifted, mw, cap)
    tparts = (p,) + twin.split_by_occupancy(p, mw, small, max_small,
                                            max_large)
    for jp, tp in zip(jparts, tparts):
        for name in jwin.WindowPartition._fields:
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)),
                                          name)
    np.testing.assert_array_equal(twin.window_counts(p, mw).numpy(),
                                  np.asarray(jwin.window_counts(jparts[0],
                                                                mw)))
    if mw < 3200:   # the reduced budgets really drop windows and tokens
        assert int(p.num_windows) > mw
        assert int(tparts[2].num_windows) == max_large

    # flat <-> window through each level
    rng = np.random.RandomState(1)
    feats = rng.randn(s.max_voxels, 8).astype(np.float32)
    for jp, tp, (w, c) in zip(jparts[1:], tparts[1:],
                              ((max_small, small), (max_large, cap))):
        jt, jm = jwin.flat_to_window(jnp.asarray(feats), jp, w, c)
        tt, tm = twin.flat_to_window(_t(feats), tp, w, c)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        back = jwin.window_to_flat(jt, jp, s.max_voxels)
        np.testing.assert_array_equal(twin.window_to_flat(tt, tp).numpy(),
                                      np.asarray(back))


def test_dynamic_vfe_matches(tiny):
    s = TINY.sst
    points, mask = tiny["points"], tiny["mask"]
    jv, tv = _voxelize_both(TINY, points, mask)
    jvfe = JVFE(feat_channels=s.vfe_channels, voxel_size=s.voxel_size,
                pc_range=s.pc_range)
    jfeat, jpts = jax.jit(lambda p, x, r: jvfe.apply(
        {"params": p}, x, r, s.max_voxels))(
            tiny["params"]["backbone"]["vfe"], points, jv)
    tvfe = TVFE(5, feat_channels=s.vfe_channels, voxel_size=s.voxel_size,
                pc_range=s.pc_range)
    sd = convert.flax_to_state_dict(tiny["params"]["backbone"]["vfe"])
    tvfe.load_state_dict(sd)
    with torch.no_grad():
        tfeat, tpts = tvfe(_t(points), tv, s.max_voxels)
    # float32 LayerNorm variance forms differ (flax E[x^2]-E[x]^2): 1e-5
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("window_shape,d_model", [((12, 12, 1), 128),
                                                  ((4, 4, 1), 32)])
def test_window_pos_embed_matches(window_shape, d_model):
    rng = np.random.RandomState(0)
    coors = np.stack([rng.randint(0, window_shape[0], 300),
                      rng.randint(0, window_shape[1], 300),
                      np.zeros(300, int)], -1).astype(np.int32)
    ref = jsst.window_pos_embed(jnp.asarray(coors), window_shape, d_model,
                                10000.0)
    got = tsst.window_pos_embed(_t(coors).long(), window_shape, d_model,
                                10000.0)
    # float32 pow/sin/cos implementations differ in the last ulps: 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def _rows_of_windows(tokens, pos, mask):
    """The JAX layer's windowed input [W, T, C] as the port's flat rows:
    row w * T + t is slot (w, t), in one level at the windows' own layout;
    the masked slots are rows that no level holds."""
    W, T, C = tokens.shape
    i = torch.arange(W * T)
    m = _t(mask).reshape(-1)
    part = twin.WindowPartition(torch.where(m, i // T, -1),
                                torch.where(m, i % T, -1),
                                torch.zeros(W * T, 3, dtype=torch.long),
                                torch.tensor(W))
    level = twin.window_level(part, W, T)
    assert torch.equal(level.mask, _t(mask))
    shift = tsst.Shift(_t(pos).reshape(-1, C), (level,), level.kept)
    return _t(tokens).reshape(-1, C), shift


def _check_rows(got, ref, tokens, mask, **tol):
    """The rows of slots the mask holds against the JAX layer's windows;
    the others keep their input (the JAX layer writes 0 there)."""
    got = got.reshape(tokens.shape).numpy()
    np.testing.assert_allclose(got[mask], np.asarray(ref)[mask], **tol)
    np.testing.assert_array_equal(got[~mask], tokens[~mask])
    np.testing.assert_array_equal(np.asarray(ref)[~mask], 0.0)


def test_window_msa_layer_matches(tiny):
    s = TINY.sst
    rng = np.random.RandomState(2)
    W, T, C = 6, s.capacity, s.d_model
    tokens = rng.randn(W, T, C).astype(np.float32)
    pos = rng.randn(W, T, C).astype(np.float32)
    mask = rng.rand(W, T) > 0.4
    mask[0] = False                  # a fully masked (padded) window
    p = tiny["params"]["backbone"]["block1_shift1"]
    jl = jsst.WindowMSALayer(s.num_heads, s.ffn_dim)
    ref = jax.jit(lambda p_, a, b, m: jl.apply({"params": p_}, a, b, m))(
        p, tokens, pos, mask)
    for use_kernel in (True, False):  # on CPU tensors both run the plain op
        tl = tsst.WindowMSALayer(C, s.num_heads, s.ffn_dim,
                                 use_kernel=use_kernel)
        tl.load_state_dict(convert.flax_to_state_dict(p))
        with torch.no_grad():
            got = tl(*_rows_of_windows(tokens, pos, mask))
        assert got.dtype == torch.float32
        # the fp32 forward bar of the repository: 2e-5
        _check_rows(got, ref, tokens, mask, atol=2e-5, rtol=2e-5)


def test_window_msa_layer_bf16_dtype_flow(tiny):
    """bf16 compute: the dense layers run in bf16, the LayerNorms return
    float32 (as flax's do with float32 parameters), so the token stream
    between layers is float32 in both packages."""
    s = TINY.sst
    rng = np.random.RandomState(5)
    W, T, C = 6, s.capacity, s.d_model
    tokens = rng.randn(W, T, C).astype(np.float32)
    pos = rng.randn(W, T, C).astype(np.float32)
    mask = rng.rand(W, T) > 0.4
    p = tiny["params"]["backbone"]["block0_shift0"]
    jl = jsst.WindowMSALayer(s.num_heads, s.ffn_dim, dtype="bfloat16")
    ref = jax.jit(lambda p_, a, b, m: jl.apply({"params": p_}, a, b, m))(
        p, tokens, pos, mask)
    tl = tsst.WindowMSALayer(C, s.num_heads, s.ffn_dim,
                             dtype=torch.bfloat16)
    tl.load_state_dict(convert.flax_to_state_dict(p))
    with torch.no_grad():
        got = tl(*_rows_of_windows(tokens, pos, mask))
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    # bf16 rounds at other places (the JAX einsum attention runs in bf16,
    # the port's in float32): 8 mantissa bits on O(1) normalised outputs
    _check_rows(got, ref, tokens, mask, atol=0.1)


def _windowed_layer(layer, x, pe, levels):
    """A layer as the windowed formulation runs it: each level's voxels
    laid into windows by ``flat_to_window``, every per-token operation on
    all ``[max_windows, capacity]`` slots, ``window_to_flat`` back; voxels
    that no level holds keep their feature."""
    dt = layer.dtype or x.dtype
    attend = window_attention if layer.use_kernel else \
        window_attention_plain
    out_x = x
    for part, mw, cap in levels:
        tokens, mask = twin.flat_to_window(x, part, mw, cap)
        pos = twin.flat_to_window(pe, part, mw, cap)[0]
        tokens = tokens.to(dt)
        qk = tokens + pos.to(dt)
        q, k = dense(layer.q, qk, dt), dense(layer.k, qk, dt)
        v = dense(layer.v, tokens, dt)
        a = attend(q, k, v, mask, layer.num_heads)
        y = layer_norm(layer.norm1, tokens + dense(layer.out, a, dt))
        f = dense(layer.ffn2, _gelu_exact(dense(layer.ffn1, y, dt)), dt)
        y = layer_norm(layer.norm2, y + f)
        y = torch.where(mask[..., None], y, 0.0)
        out_x = torch.where((part.win_of_voxel >= 0)[:, None],
                            twin.window_to_flat(y, part), out_x)
    return out_x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_flat_rows_match_the_windowed_blocks(use_kernel, dtype):
    """The blocks on flat voxel rows against the windowed formulation they
    replace, forward and gradients, through every layer of the tiny SST.
    Budgets of 12 windows, capacity 10, a small level of 8 tokens in 6
    windows and a large one of 4: windows beyond the budget, tokens beyond
    the capacity, voxels that every level drops, and invalid voxel rows."""
    cfg = dataclasses.replace(tsst.tiny_sst_config(), compute_dtype=dtype,
                              use_pallas_attention=use_kernel)
    torch.manual_seed(0)
    sst = tsst.SST(cfg)
    with torch.no_grad():
        for name, p in sst.named_parameters():
            if name.endswith("bias"):
                p.normal_(0, 0.1)
            elif "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    points, mask = _frame(TINY, 500, seed=3)
    vres = tvx.voxelize(_t(points), _t(mask), cfg.voxel_size, cfg.pc_range,
                        cfg.max_voxels)
    valid = vres.voxel_valid
    shifts, windowed = [], []
    for shifted in (False, True):
        p = twin.partition(vres.coords, valid, cfg.grid_shape,
                           cfg.window_shape, shifted, 12, 10)
        ps, pl = twin.split_by_occupancy(p, 12, 8, 6, 4)
        levels = ((ps, 6, 8), (pl, 4, 10))
        pe = tsst.window_pos_embed(p.coors_in_win, cfg.window_shape,
                                   cfg.d_model, cfg.pos_temperature)
        flat = tuple(twin.window_level(*lv) for lv in levels)
        kept = flat[0].kept | flat[1].kept
        shifts.append(tsst.Shift(pe, flat, kept))
        windowed.append((pe, levels))
        whole = twin.partition(vres.coords, valid, cfg.grid_shape,
                               cfg.window_shape, shifted, 100, 16)
        assert int(p.num_windows) > 12
        assert int(twin.window_counts(whole, 100).max()) > 10
        assert all(bool(lv.kept.any()) for lv in flat)
        assert bool((valid & ~kept).any()) and not bool(kept[~valid].any())
    assert bool((~valid).any())
    x0 = torch.randn(cfg.max_voxels, cfg.d_model) * valid[:, None]
    weight = torch.randn(cfg.max_voxels, cfg.d_model)

    def run(flat):
        x = x0.clone().requires_grad_(True)
        h = x
        for i, layer in enumerate(sst.layers):
            h = layer(h, shifts[i % 2]) if flat else \
                _windowed_layer(layer, h, *windowed[i % 2])
        (h * weight).sum().backward()
        grads = {n: p.grad.clone() for n, p in sst.layers.named_parameters()}
        sst.zero_grad()
        return h.detach(), x.grad, grads

    (got, gx, gp), (ref, rx, rp) = run(True), run(False)
    assert got.dtype == torch.float32
    assert torch.equal(got[~valid], torch.zeros_like(got[~valid]))
    # the fp32 forward bar of the repository: 2e-5
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                               rtol=2e-5)
    # the repository's float32 gradient bar: 1e-4
    np.testing.assert_allclose(gx.numpy(), rx.numpy(), atol=1e-4, rtol=0)
    assert set(gp) == set(rp)
    for name, g in gp.items():
        # bf16 weight gradients are bf16 products summed over other rows
        # (the windows' empty slots add zeros in another order): a few
        # bf16 steps of the leaf's largest entry
        atol = 1e-4 + (2 ** -6 * float(rp[name].abs().max())
                       if dtype == "bfloat16" else 0.0)
        np.testing.assert_allclose(g.numpy(), rp[name].numpy(), atol=atol,
                                   rtol=0, err_msg=name)


def test_coder_encode_decode_match():
    rng = np.random.RandomState(0)
    n = 200
    a = np.concatenate([rng.uniform(-50, 50, (n, 3)),
                        rng.uniform(0.5, 5, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    g = np.concatenate([rng.uniform(-50, 50, (n, 3)),
                        rng.uniform(0.5, 5, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    a, g = a.astype(np.float32), g.astype(np.float32)
    d_ref = np.asarray(jcoder.encode(jnp.asarray(a), jnp.asarray(g)))
    d = tcoder.encode(_t(a), _t(g))
    # float32 elementwise math: 1e-5
    np.testing.assert_allclose(d.numpy(), d_ref, atol=1e-5, rtol=1e-5)
    b_ref = np.asarray(jcoder.decode(jnp.asarray(a), jnp.asarray(d_ref)))
    np.testing.assert_allclose(tcoder.decode(_t(a), _t(d_ref)).numpy(),
                               b_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tcoder.decode(_t(a), d).numpy(), g,
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("acfg", [jah.AnchorConfig(),
                                  jah.waymo_3class_anchor_config()])
def test_generate_anchors_non_square(acfg):
    pc = (-10.0, -6.0, -2.0, 14.0, 6.0, 4.0)
    ref = np.asarray(jah.generate_anchors((12, 5), pc, acfg))
    tcfg = tah.AnchorConfig(**dataclasses.asdict(acfg))
    got = tah.generate_anchors((12, 5), pc, tcfg)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_tiny_detector_forward_matches(tiny):
    _check_forward(tiny, (24, 24))


def test_predict_fn_shapes_and_decode(tiny):
    model = tiny["tmodel"]
    pts, msk = _t(tiny["points"]), _t(tiny["mask"])
    boxes, scores, labels, valid = make_predict_fn(model, "sst")(pts, msk)
    assert boxes.shape == (500, 7) and scores.shape == (500,)
    assert labels.shape == (500,) and valid.shape == (500,)
    assert torch.isfinite(boxes).all() and valid.dtype == torch.bool
    # the decode of the JAX package on the port's own raw maps agrees
    with torch.no_grad():
        out = model(pts, msk)
    ref = jah.anchor_head_decode(
        jnp.asarray(out["cls"].numpy()), jnp.asarray(out["reg"].numpy()),
        jnp.asarray(out["dir"].numpy()), jnp.asarray(model.anchors.numpy()),
        TINY.anchors, 500)
    # float32 sigmoids differ in the last ulp: 1e-6
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref[1]), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(ref[0]), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="unknown detector family"):
        make_predict_fn(model, "pointpillars")


def test_tiny_detector_bf16_runs_close_to_fp32(tiny):
    """bfloat16 compute with float32 parameters and norm statistics: the
    outputs stay float32 and close to the fp32 forward (bf16 keeps about 3
    significant digits; 12 rounded layers: atol 0.1 on O(1) maps)."""
    cfg = tdet.tiny_sst_detector_config()
    cfg = dataclasses.replace(cfg, sst=dataclasses.replace(
        cfg.sst, compute_dtype="bfloat16"))
    m16 = tdet.SSTDetector(cfg, device="cpu")
    m16.load_state_dict(tiny["tmodel"].state_dict())
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    with torch.no_grad():
        out = m16(_t(tiny["points"]), _t(tiny["mask"]))
    for k in ("cls", "reg", "dir"):
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), tiny["ref"][k], atol=0.1)


def test_seeded_init_is_reproducible():
    cfg = tdet.tiny_sst_detector_config()
    a = tdet.SSTDetector(cfg, "cpu", torch.Generator().manual_seed(5))
    b = tdet.SSTDetector(cfg, "cpu", torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert torch.all(a.head.cls.bias == -4.59)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tdet.SSTDetector(tdet.tiny_sst_detector_config())
