"""The port's OcOccNet serving path held against the JAX package on the CPU.

Inputs are made from a numpy seed (the port's ``synthetic_batch``, which
gives the JAX package's arrays) and go through the JAX function and its
counterpart in ``objectcentricocccompletion_torch``; weights cross over
through ``convert.py``. One JAX parameter tree per variant (shapes from
``jax.eval_shape``, values from numpy) and one jitted JAX forward per
config are shared by the whole file.

Bars: float32 forward within 2e-4 absolute (the SST bar); bfloat16 within
0.1 on O(1) outputs (bf16 keeps about 3 significant digits and rounds at
other places in the two packages).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.configs import ococcnet_config as jcfgm
from objectcentricocccompletion_tpu.data.synthetic import (
    synthetic_batch as jax_synthetic_batch)
from objectcentricocccompletion_tpu.models import layers as jlayers
from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_tpu.models.occ_decoder import (
    OccDecoder as JOccDecoder)
from objectcentricocccompletion_tpu.models.sir import SIREncoder as JSIR
from objectcentricocccompletion_tpu.models.transformer import (
    TemporalEncoder as JTemporal)
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.configs import ococcnet_config as tcfgm
from objectcentricocccompletion_torch.data.synthetic import synthetic_batch
from objectcentricocccompletion_torch.models import layers as tlayers
from objectcentricocccompletion_torch.models import ococcnet as tnet
from objectcentricocccompletion_torch.models.occ_decoder import OccDecoder
from objectcentricocccompletion_torch.models.sir import SIREncoder
from objectcentricocccompletion_torch.models.transformer import (
    TemporalEncoder)
from objectcentricocccompletion_torch.ops import packed as tpk
from objectcentricocccompletion_torch.tools import benchmark as bench

FP32_TOL = 2e-4
BF16_TOL = 0.1
TINY = jcfgm.tiny_config()
CONFIGS = {
    "dense": TINY,
    # the per-RoI compaction runs (frames hold up to 64 points)
    "compact": dataclasses.replace(TINY, roi_point_budget=24),
    # packed over budget (8 frames of 16-64 points into 128 slots), aligned
    # and tight
    "packed": dataclasses.replace(TINY, packed_point_budget=128,
                                  packed_quantum=16),
    "packed_q0": dataclasses.replace(TINY, packed_point_budget=128,
                                     packed_quantum=0),
    "ctrl": dataclasses.replace(TINY, variant="ctrl"),
}
OUT_KEYS = ("boxes", "scores", "cls_logit", "bbox_pred", "shape_latent",
            "ae_latent", "nonempty")


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


def _torch_config(jcfg, **kw):
    return tcfgm.OcOccNetConfig(**{**dataclasses.asdict(jcfg), **kw})


def _batch(cfg, seed=1):
    """The synthetic batch with one frame emptied (no point survives)."""
    b = synthetic_batch(_torch_config(cfg), seed=seed)
    b.points_mask[0, 2] = False
    return b


def _jbatch(b):
    return jnet.TrackletBatch(*(x.numpy() for x in b))


def _serve(model, batch):
    """The serving path inside a flax module: predict, then (OcOccNet) the
    occupancy decode of the batch's samples."""
    out = model.predict(batch)
    if model.cfg.variant != "ococc":
        return out, None
    q = jnet.gt_occ_to_roi_frame(batch.occ_points, batch.gt_boxes,
                                 batch.rois)
    return out, model.decode_occ_queries(out["shape_latent"], q)


def _param_shapes(cfg, batch):
    """The parameter tree's shapes; the serving path creates every
    parameter, and tracing it skips the losses."""
    model = jnet.OcOccNetWithLoss(cfg)
    return jax.eval_shape(lambda b: model.init(
        {"params": jax.random.PRNGKey(0)}, b, method=_serve), batch)["params"]


_PARAMS = {}


def _params(variant):
    """One numpy parameter tree per variant, shared by the file."""
    if variant not in _PARAMS:
        cfg = CONFIGS["ctrl" if variant == "ctrl" else "dense"]
        shapes = _param_shapes(cfg, _jbatch(_batch(cfg)))
        _PARAMS[variant] = jax.tree_util.tree_map(
            np.asarray, _random_params(shapes, 7))
    return _PARAMS[variant]


def _jax_forward(cfg):
    """predict + decode_occ_queries of the JAX package, jitted once."""
    model = jnet.OcOccNetWithLoss(cfg)
    return jax.jit(lambda p, b: model.apply({"params": p}, b,
                                            method=_serve))


def _port_forward(model, b):
    with torch.no_grad():
        out = model.predict(b)
        if model.cfg.variant != "ococc":
            return out, None
        q = tnet.gt_occ_to_roi_frame(b.occ_points, b.gt_boxes, b.rois)
        return out, model.decode_occ_queries(out["shape_latent"], q)


def _port_model(jcfg, params, **kw):
    model = tnet.OcOccNetWithLoss(_torch_config(jcfg, **kw), device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(params))
    return model.eval()


def _compare(got, ref, atol, keys=OUT_KEYS):
    out, occ = got
    rout, rocc = ref
    for k in keys:
        a, r = out[k], np.asarray(rout[k])
        assert tuple(a.shape) == r.shape, k
        if k == "nonempty":
            np.testing.assert_array_equal(a.numpy(), r)
            continue
        np.testing.assert_allclose(a.float().numpy(), r.astype(np.float32),
                                   atol=atol, rtol=0, err_msg=k)
    if rocc is not None:
        assert occ.dtype == torch.float32
        np.testing.assert_allclose(occ.numpy(), np.asarray(rocc), atol=atol,
                                   rtol=0, err_msg="occupancy logits")


def test_configs_match_the_jax_package():
    for name in ("OcOccNetConfig", "tiny_config", "ctrl_veh_config",
                 "ctrl_ped_config", "ctrl_cyc_config"):
        assert dataclasses.asdict(getattr(jcfgm, name)()) == \
            dataclasses.asdict(getattr(tcfgm, name)()), name
    assert tcfgm.OcOccNetConfig().points_dim == 10


@pytest.mark.parametrize("full", [False, True], ids=["tiny", "full"])
def test_synthetic_batch_equals_the_jax_package(full):
    cfg = jcfgm.OcOccNetConfig() if full else TINY
    ref = jax_synthetic_batch(cfg, batch_size=4 if full else None, seed=3)
    got = synthetic_batch(_torch_config(cfg), batch_size=4 if full else None,
                          seed=3)
    for name, a, r in zip(jnet.TrackletBatch._fields, got, ref):
        r = np.asarray(r)
        assert a.numpy().dtype == r.dtype and a.shape == r.shape, name
        np.testing.assert_array_equal(a.numpy(), r, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_and_gelu_match(dtype):
    """The hidden layers (Dense, one-pass LN eps 1e-3, GELU) and the biased
    head layer; the GELU alone: exact erf in float32, tanh in bf16."""
    rng = np.random.RandomState(0)
    x = (3 * rng.randn(6, 9, 11)).astype(np.float32)
    tdt = getattr(torch, dtype)
    for is_head in (True, False):
        jm = jlayers.Mlp((16, 24, 5), is_head=is_head, dtype=dtype)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"]
        params = jax.tree_util.tree_map(np.asarray,
                                        _random_params(shapes, 1))
        ref = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, x)
        tm = tlayers.Mlp(11, (16, 24, 5), is_head=is_head, dtype=tdt)
        tm.load_state_dict(convert.flax_to_state_dict(params))
        with torch.no_grad():
            got = tm(_t(x))
        assert got.dtype == tdt
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(ref, np.float32),
            atol=FP32_TOL if dtype == "float32" else BF16_TOL, rtol=0)
    xs = jnp.asarray(x, dtype)
    ref = np.asarray(jax.jit(jlayers._gelu_auto)(xs), np.float32)
    got = tlayers.gelu_auto(_t(x).to(tdt))
    assert got.dtype == tdt
    # float32: erf in two libraries (1e-6); bf16: one rounding of O(3)
    # values (2^-8 relative) against a chain of bf16 roundings
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=1e-6 if dtype == "float32" else 0.05,
                               rtol=0)


def test_position_encodings_match():
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 200, (3, 32)).astype(np.int32)
    for d in (1536, 128):
        ref = jax.jit(lambda f: jlayers.sinusoidal_position_encoding(f, d))(
            frames)
        got = tlayers.sinusoidal_position_encoding(_t(frames), d)
        # angles up to 200 rad: one float32 ulp of the angle (1.5e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5,
                                   rtol=0)
    # queries inside the bound and beyond it (angles up to 512 pi and more)
    q = rng.uniform(-10, 10, (4, 50, 3)).astype(np.float32)
    ref = jax.jit(jlayers.nerf_position_encoding)(q)
    got = tlayers.nerf_position_encoding(_t(q))
    assert got.shape == (4, 50, 60)
    # the angles agree bit for bit; sin and cos of large float32 angles in
    # two libraries: 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def _sir_inputs(layout, geo, rng):
    """Dense [G, P] groups or their packed forms (by the JAX packing), one
    group empty; the feature widths of the tiny OcOccNet's encoders."""
    B, L, P = 2, 4, 24
    F = 8 if geo else 12
    mask = rng.rand(B, L, P) < 0.7
    mask[0, 1] = False
    xyz = (3 * rng.randn(B, L, P, 3)).astype(np.float32)
    feats = rng.randn(B, L, P, F).astype(np.float32)
    fcl = rng.randn(B, L, P, 13).astype(np.float32) if geo else None
    if layout == "dense":
        def flat(x):
            return x.reshape((B * L,) + x.shape[2:])
        return (flat(xyz), flat(feats), flat(mask),
                None if fcl is None else flat(fcl)), {}
    # the port's packing (equal to the JAX package's:
    # tests/test_torch_ococc_ops.py)
    if layout == "blocked":
        p = tpk.pack_groups_aligned(_t(mask), 64, 8)
    else:
        p = tpk.pack_groups(_t(mask), 64)

    def rows(x):
        return None if x is None else tpk.pack_rows(_t(x), p.order).numpy()
    args = (rows(xyz), rows(feats), p.valid.numpy(), rows(fcl))
    kw = {"seg_ids": p.seg_ids.numpy().astype(np.int32), "num_segments": L,
          "block_seg": (None if p.block_seg is None
                        else p.block_seg.numpy().astype(np.int32))}
    return args, kw


@pytest.mark.parametrize("geo", [True, False], ids=["geo", "ae"])
@pytest.mark.parametrize("layout", ["dense", "tight", "blocked"])
def test_sir_encoder_matches(layout, geo):
    """Both wirings (geo_input: the RoI encoder; not: the AE, with the
    group-mean f_cluster and the shortcut from block 1 on) in all three
    layouts, with the tiny OcOccNet's encoder weights (two blocks of
    (32, 32))."""
    rng = np.random.RandomState(2)
    args, kw = _sir_inputs(layout, geo, rng)
    S = kw.pop("num_segments", None)
    cfg = TINY
    if geo:
        params = _params("ococc")["net"]["roi_encoder"]
        norm, feat_dim, rel_dim = cfg.xyz_normalizer, 8, 13
    else:
        params = _params("ococc")["net"]["ae_encoder"]
        norm, feat_dim, rel_dim = cfg.ae_xyz_normalizer, 12, 3
    jm = JSIR(num_blocks=cfg.num_blocks, feat_channels=cfg.feat_channels,
              rel_mlp_hidden=cfg.rel_mlp_hidden, xyz_normalizer=norm,
              geo_input=geo)
    ref = jax.jit(lambda p, *a, **k: jm.apply({"params": p}, *a,
                                              num_segments=S, **k))(
        params, *args, **kw)
    tm = SIREncoder(feat_dim, rel_dim, cfg.num_blocks, cfg.feat_channels,
                    cfg.rel_mlp_hidden, norm, geo_input=geo)
    tm.load_state_dict(convert.flax_to_state_dict(params))
    targs = [None if a is None else _t(a) for a in args]
    tkw = {k: None if v is None else _t(v).long() for k, v in kw.items()}
    with torch.no_grad():
        got = tm(*targs, num_segments=S, **tkw)
    for a, r in zip(got, ref):
        assert tuple(a.shape) == np.asarray(r).shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=FP32_TOL,
                                   rtol=0)
    roi = got[1].reshape(-1, 4, got[1].shape[-1])
    assert torch.equal(roi[0, 1], torch.zeros(roi.shape[-1]))  # empty


def test_temporal_encoder_window_3_matches():
    """Causal attention restricted to the last 3 frames (the predict
    tests run the full causal window)."""
    window = 3
    rng = np.random.RandomState(4)
    src = rng.randn(2, 8, 128).astype(np.float32)
    pos = rng.randn(2, 8, 128).astype(np.float32)
    params = _params("ococc")["net"]["temporal"]
    jm = JTemporal(num_layers=1, num_heads=4, ffn_dim=64)
    ref = jax.jit(lambda p, s, q: jm.apply({"params": p}, s, q, causal=True,
                                           window=window))(params, src, pos)
    tm = TemporalEncoder(128, 1, 4, 64)
    tm.load_state_dict(convert.flax_to_state_dict(params))
    with torch.no_grad():
        got = tm(_t(src), _t(pos), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=0)


def test_occ_decoder_matches():
    rng = np.random.RandomState(5)
    latent = rng.randn(2, 8, 128).astype(np.float32)
    queries = rng.uniform(-3, 3, (2, 8, 32, 3)).astype(np.float32)
    params = _params("ococc")["net"]["occ_decoder"]
    jm = JOccDecoder(mlp_dims=(32, 32, 32))
    ref = jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(
        params, latent, queries)
    tm = OccDecoder(128, (32, 32, 32))
    tm.load_state_dict(convert.flax_to_state_dict(params))
    with torch.no_grad():
        got = tm(_t(latent), _t(queries))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=0)
    np.testing.assert_array_equal(
        tm.classify(got).numpy(),
        np.asarray(jm.apply({"params": params}, ref,
                            method=JOccDecoder.classify)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_predict_and_decode_match(name):
    cfg = CONFIGS[name]
    params = _params("ctrl" if cfg.variant == "ctrl" else "ococc")
    b = _batch(cfg)
    ref = _jax_forward(cfg)(params, _jbatch(b))
    got = _port_forward(_port_model(cfg, params), b)
    _compare(got, ref, FP32_TOL)
    nonempty = got[0]["nonempty"]
    assert not nonempty[0, 2] and nonempty.sum() > 1   # the emptied frame
    if cfg.variant == "ococc":
        assert got[1].shape == (2, 8, 32)


def test_bf16_dtype_flow_matches():
    """bfloat16 compute, packed layout: the same casts as the JAX package
    (float32 parameters, norm statistics, softmax and head outputs)."""
    cfg = dataclasses.replace(CONFIGS["packed"], compute_dtype="bfloat16")
    params = _params("ococc")
    b = _batch(cfg)
    ref = _jax_forward(cfg)(params, _jbatch(b))
    got = _port_forward(_port_model(cfg, params), b)
    assert got[0]["ae_latent"].dtype == torch.bfloat16
    assert np.asarray(ref[0]["ae_latent"]).dtype == jnp.bfloat16
    for k in ("cls_logit", "bbox_pred", "shape_latent", "boxes"):
        assert got[0][k].dtype == torch.float32, k
    # the O(1) outputs (the boxes are their float32 decode, in metres)
    _compare(got, ref, BF16_TOL, ("scores", "cls_logit", "bbox_pred",
                                  "shape_latent", "ae_latent", "nonempty"))


def test_convert_round_trip_full_config():
    """The whole ``OcOccNetConfig()`` tree (shapes from ``jax.eval_shape``
    on a short tracklet, nothing runs; traced in the dense layout, whose
    tree is the packed one's): every flax leaf lands in the port's module
    shape for shape and comes back unchanged."""
    cfg = jcfgm.OcOccNetConfig()
    B, L, P, K = 1, 4, 16, 8
    f32 = jnp.float32
    S = jax.ShapeDtypeStruct
    batch = jnet.TrackletBatch(
        S((B, L, P, cfg.points_dim), f32), S((B, L, P), jnp.bool_),
        S((B, L, 7), f32), S((B, L), f32), S((B, L), jnp.int32),
        S((B, L, 7), f32), S((B, L), jnp.bool_), S((B, K, 3), f32),
        S((B, K), jnp.int32), S((B, K), jnp.bool_), S((B,), f32))
    shapes = _param_shapes(dataclasses.replace(
        cfg, packed_point_budget=None, roi_point_budget=None), batch)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.random(s.shape, np.float32), shapes)
    sd = convert.flax_to_state_dict(params)
    tmodel = tnet.OcOccNetWithLoss(_torch_config(cfg), device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    back = convert.state_dict_to_flax(tmodel.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert flat_b[path].shape == leaf.shape, path
        assert np.array_equal(flat_b[path], leaf), path


def test_unported_options_raise():
    tiny = tcfgm.tiny_config()
    for kw in ({"use_segmentor": "tiny"}, {"remat_sir": True}):
        with pytest.raises(NotImplementedError):
            tnet.OcOccNetWithLoss(dataclasses.replace(tiny, **kw), "cpu")
    model = tnet.OcOccNetWithLoss(tiny, "cpu")
    b = synthetic_batch(tiny)
    with pytest.raises(NotImplementedError, match="next slice"):
        model(b)
    with pytest.raises(NotImplementedError, match="dropout"):
        model.net(b, train=True)
    # without dropout a training forward runs (full causal window)
    nodrop = dataclasses.replace(
        tiny, occ_dropout=0.0, attn_dropout=0.0, cls_dropout=0.0,
        reg_dropout=0.0, latent_dropout=0.0, fusion_dropout=0.0,
        test_attn_window=2)
    m2 = tnet.OcOccNetWithLoss(nodrop, "cpu")
    m2.load_state_dict(model.state_dict())
    with torch.no_grad():
        a = m2.net(b, train=True)["cls_logit"]
        c = model.net(b)["cls_logit"]
    np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-6, rtol=0)


def test_seeded_init_is_reproducible():
    cfg = tcfgm.tiny_config()
    a = tnet.OcOccNetWithLoss(cfg, "cpu", torch.Generator().manual_seed(5))
    b = tnet.OcOccNetWithLoss(cfg, "cpu", torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_benchmark_functions_on_cpu(layout):
    """The ``ococcnet`` benchmark's functions at ``tiny_config()`` on the
    CPU: its config per layout, predict, the occupancy decode and the
    result line."""
    full = bench.ococcnet_config("bfloat16", layout)
    assert full.compute_dtype == "bfloat16" and full.d_model == 1536
    assert full.packed_point_budget == (8192 if layout == "packed" else None)
    assert full.roi_point_budget == 640
    cfg = bench.ococcnet_config("float32", layout, cfg=dataclasses.replace(
        tcfgm.tiny_config(), packed_point_budget=128, packed_quantum=16))
    assert cfg.packed_point_budget == (128 if layout == "packed" else None)
    res = bench.bench_ococcnet(batches=2, dtype="float32", layout=layout,
                               device="cpu", batch=2, cfg=cfg)
    assert res["family"] == "ococcnet" and res["eval_layout"] == layout
    assert res["batch"] == 2 and res["latency_ms"] > 0
    assert res["fps"] == pytest.approx(2e3 / res["latency_ms"])
    assert res["decode_queries"] == 32 and res["peak_memory_gib"] is None
    shapes = res["shapes"]
    assert shapes["boxes"] == [2, 8, 7] and shapes["occ_logits"] == [2, 8, 32]
    # the layout's points: 8 frames of 16-64 points; the packed layout's
    # 128 slots per tracklet bind, the dense one keeps every pooled point
    assert 0 < res["points_kept"] <= res["points_pooled"] <= \
        res["points_valid"] <= 2 * 8 * 64
    assert res["point_slots"] == (2 * 128 if layout == "packed"
                                  else 2 * 8 * 64)
    if layout == "packed":
        assert res["points_kept"] < res["points_pooled"]
    else:
        assert res["points_kept"] == res["points_pooled"]


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tnet.OcOccNetWithLoss(tcfgm.tiny_config())
    with pytest.raises(RuntimeError, match="cuda"):
        bench.bench_ococcnet(batches=1, cfg=tcfgm.tiny_config())
