"""The column-dense layout of CenterPoint's sparse encoder in the port
(``ops/column_conv.py``, ``SparseEncoder(layout="column")``,
``DynamicCenterPoint(encoder_layout="column")``) held against the JAX
package on the CPU, on the same numpy inputs and converted weights.

Bars: integer outputs (column tables, masks, slots) equal exactly; float32
outputs within 1e-5 (one GEMM's order of summation against XLA's); the
float32 encoder's BEV within 2e-5 of its largest value and every gradient
at atol 1e-4 (the gather layout's bars, ``test_torch_centerpoint.py``);
bf16 at ``BF16_RTOL`` (beside it).

A file of at most four tests (pytest-xdist's ``--dist loadfile``; see
``test_torch_centerpoint.py``); every JAX reference is one jitted
function."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from objectcentricocccompletion_tpu.models import centerpoint as jcp
from objectcentricocccompletion_tpu.models import centerpoint_head as jcph
from objectcentricocccompletion_tpu.models.sparse_encoder import (
    SparseEncoder as JaxEncoder)
from objectcentricocccompletion_tpu.ops import column_conv as jcc
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import centerpoint as tcp
from objectcentricocccompletion_torch.models import centerpoint_head as tcph
from objectcentricocccompletion_torch.models.sparse_encoder import (
    SparseEncoder)
from objectcentricocccompletion_torch.ops import column_conv as cc
from tests.test_torch_centerpoint import (HEADS, assert_close, cp_frame,
                                          random_params)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

FWD_RTOL = 2e-5
GRAD_ATOL = 1e-4
# bf16 activations, both packages rounding at the same points: a float32
# sum that lands within its own rounding of a bf16 rounding boundary rounds
# the other way in the other package (one bf16 ulp, 2^-8 relative), and the
# later layers mix such flips; 2^-5 of the map's largest value is 8 ulps
BF16_RTOL = 2.0 ** -5
# a small encoder of two stages (XLA's CPU compile time grows with the
# layers): a block with a projection, a downsample, a block, z 17 -> 9 ->
# conv_out 4
ENC = dict(base_channels=4, output_channels=8,
           encoder_channels=((8,), (8,)), grid_shape=(20, 18, 17),
           max_voxels_per_stage=(400, 400), max_columns_per_stage=(400, 200))


def voxels(seed, grid_shape, n_active, n_slots, n_feat):
    """Unique random active voxels, padded to ``n_slots``
    (numpy: feats [n_slots, n_feat], coords [n_slots, 3], valid)."""
    rng = np.random.RandomState(seed)
    gx, gy, gz = grid_shape
    keys = rng.choice(gx * gy * gz, size=n_active, replace=False)
    coords = np.zeros((n_slots, 3), np.int32)
    coords[:n_active] = np.stack(
        [keys // (gy * gz), (keys // gz) % gy, keys % gz], -1)
    valid = np.arange(n_slots) < n_active
    feats = rng.randn(n_slots, n_feat).astype(np.float32)
    feats[~valid] = 0.0
    return feats, coords, valid


def _jax_ops(feats, coords, valid, w, w_out, gs, max_cols, max_out):
    grid, col_of = jcc.build_columns(coords, valid, gs, max_cols)
    x = jcc.scatter_voxel_feats(feats, coords, col_of, max_cols, gs[2])
    nbrs = jcc.neighbor_columns(grid)
    w9 = w.reshape(9, 3, w.shape[1], w.shape[2])
    og, s_nbrs = jcc.downsample_columns(grid, max_out)
    down = jcc.conv3x3x3(x, s_nbrs, w, og.occ, stride=2)
    zq, zocc = jcc.zcompress(down, og.occ, w_out)
    ogz = zocc.shape[1]
    xb = x.astype(jnp.bfloat16)
    return dict(
        col_xy=grid.col_xy, col_valid=grid.col_valid, occ=grid.occ,
        col_index=grid.col_index, col_of=col_of, x=x, nbrs=nbrs,
        pad_rows=jcc._pad_rows(x),
        gathered=jcc._gather_columns_padded(jcc._pad_rows(x), nbrs[4], gs[2]),
        gathered0=jcc._gather_columns(x, nbrs[0]),
        zconv=jcc._zconv(x, w9[4], 1, (1, 1)),
        zconv_s2=jcc._zconv(x, w9[2], 2, (1, 1)),
        zconv_bf16=jcc._zconv(xb, w9[4], 1, (1, 1)),
        subm=jcc.conv3x3x3(x, nbrs, w, grid.occ),
        subm_bf16=jcc.conv3x3x3(xb, nbrs, w, grid.occ),
        out_xy=og.col_xy, out_valid=og.col_valid, out_occ=og.occ,
        out_index=og.col_index, s_nbrs=s_nbrs, down=down, zq=zq, zocc=zocc,
        bev=jcc.columns_to_bev(zq, og._replace(
            occ=zocc, grid_shape=og.grid_shape[:2] + (ogz,))))


def test_column_functions_equal_the_jax_package():
    """Every function of ``ops/column_conv.py`` on two grids: (16, 12, 9)
    within its budgets, and (10, 11, 7) whose columns overflow the stage
    budget (40) and whose downsample overflows its own (12)."""
    cases = (((16, 12, 9), 70, 96, 96, 64), ((10, 11, 7), 200, 256, 40, 12))
    for seed, (gs, n_active, n_slots, max_cols, max_out) in enumerate(cases):
        feats, coords, valid = voxels(seed, gs, n_active, n_slots, 5)
        rng = np.random.RandomState(10 + seed)
        w = (rng.randn(27, 5, 6) / np.sqrt(27 * 5)).astype(np.float32)
        w_out = (rng.randn(3, 6, 4) / np.sqrt(18)).astype(np.float32)
        ref = jax.jit(_jax_ops, static_argnums=(5, 6, 7))(
            feats, coords, valid, w, w_out, gs, max_cols, max_out)
        ref = {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                             else v) for k, v in ref.items()}
        f, c, v = (torch.from_numpy(a) for a in (feats, coords, valid))
        tw, tw_out = torch.from_numpy(w), torch.from_numpy(w_out)
        grid, col_of = cc.build_columns(c, v, gs, max_cols)
        x = cc.scatter_voxel_feats(f, c, col_of, max_cols, gs[2])
        nbrs = cc.neighbor_columns(grid)
        w9 = tw.reshape(9, 3, 5, 6)
        og, s_nbrs = cc.downsample_columns(grid, max_out)
        down = cc.conv3x3x3(x, s_nbrs, tw, og.occ, stride=2)
        zq, zocc = cc.zcompress(down, og.occ, tw_out)
        xb = x.to(torch.bfloat16)
        got = dict(
            col_xy=grid.col_xy, col_valid=grid.col_valid, occ=grid.occ,
            col_index=grid.col_index, col_of=col_of, x=x, nbrs=nbrs,
            pad_rows=cc._pad_rows(x),
            gathered=cc._gather_columns_padded(cc._pad_rows(x), nbrs[4],
                                               gs[2]),
            gathered0=cc._gather_columns(x, nbrs[0]),
            zconv=cc._zconv(x, w9[4], 1, (1, 1)),
            zconv_s2=cc._zconv(x, w9[2], 2, (1, 1)),
            zconv_bf16=cc._zconv(xb, w9[4], 1, (1, 1)),
            subm=cc.conv3x3x3(x, nbrs, tw, grid.occ),
            subm_bf16=cc.conv3x3x3(xb, nbrs, tw, grid.occ),
            out_xy=og.col_xy, out_valid=og.col_valid, out_occ=og.occ,
            out_index=og.col_index, s_nbrs=s_nbrs, down=down, zq=zq,
            zocc=zocc, bev=cc.columns_to_bev(zq, og._replace(
                occ=zocc, grid_shape=og.grid_shape[:2] + (zocc.shape[1],))))
        assert og.grid_shape == tuple(
            (g + 2 - 3) // 2 + 1 for g in gs)
        assert set(got) == set(ref)
        for k, r in ref.items():
            g = got[k].numpy()
            assert g.shape == r.shape, (k, g.shape, r.shape)
            if r.dtype.kind in "biu":
                np.testing.assert_array_equal(g, r, err_msg=k)
            else:
                assert got[k].dtype == torch.float32, k
                np.testing.assert_allclose(g, r, rtol=0, atol=1e-5,
                                           err_msg=k)
        n_cols = len({tuple(xy) for xy in coords[valid, :2]})
        counts = cc.column_counts(c, v, gs, (max_cols, max_out))
        assert counts[0] == n_cols and counts[1] >= int(og.col_valid.sum())
        if max_cols < n_cols:    # the overflow case: budgets full, cut
            assert ref["col_valid"].all() and ref["out_valid"].all()
            assert counts[1] > max_out
            assert (ref["col_of"][valid] == max_cols).any()
        assert ref["subm"].any() and ref["bev"].any()


def _encoder_params(shapes, seed):
    """flax-shaped encoder params: kernels by fan-in, norm scales near 1,
    small biases."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name.endswith("kernel"):
            return (rng.randn(*s.shape) * np.sqrt(
                2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _encoders(dtype, remat=True):
    """JAX and port column encoders on one converted tree, the voxels, and
    a seeded cotangent of the BEV."""
    feats, coords, valid = voxels(3, ENC["grid_shape"], 300, 400, 4)
    jenc = JaxEncoder(layout="column", dtype=dtype, remat_blocks=remat,
                      **ENC)
    tenc = SparseEncoder(layout="column", dtype=dtype, remat_blocks=remat,
                         **ENC)
    # the flax tree's shapes through the converter (tracing the JAX init
    # costs seconds); the encoder's names sit at the top of its tree
    params = _encoder_params(convert.state_dict_to_flax(tenc.state_dict()),
                             1)
    tenc.load_state_dict({k.lstrip("."): v for k, v in
                          convert.flax_to_state_dict(params).items()})
    return jenc, tenc, params, (feats, coords, valid)


def test_column_encoder_float32_with_remat_equals_the_jax_package():
    """The float32 column encoder with remat: its BEV, and the gradient of
    a seeded projection of it for every parameter and the voxel features;
    the converter's round trip of the column tree is exact, with the gather
    layout's names."""
    jenc, tenc, params, (feats, coords, valid) = _encoders("float32")
    gx, gy, _ = ENC["grid_shape"]
    # a seeded projection of the BEV, averaged: O(1) gradients
    cot = np.random.RandomState(5).randn(
        (gx - 1) // 2 + 1, (gy - 1) // 2 + 1, 4 * 8).astype(np.float32)
    cot /= cot.size

    def loss(p, f):
        bev = jenc.apply({"params": p}, f, coords, valid)
        return jnp.sum(bev * cot), bev

    (_, bev), (gp, gf) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, feats)
    f = torch.from_numpy(feats).requires_grad_()
    got = tenc(f, torch.from_numpy(coords), torch.from_numpy(valid))
    assert got.shape == (1, 32) + cot.shape[:2]
    got = got[0].permute(1, 2, 0)
    assert np.abs(np.asarray(bev)).max() > 0.1
    assert_close(got.detach(), bev, "column BEV")
    (got * torch.from_numpy(cot)).sum().backward()
    assert_close(f.grad, gf, "voxel feature gradient")
    tree = convert.state_dict_to_flax(
        {n: p.grad for n, p in tenc.named_parameters()})
    ref = jax.tree_util.tree_flatten_with_path(gp)[0]
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(ref) == len(flat) == len(list(tenc.parameters()))
    worst = max(float(np.abs(flat[p] - np.asarray(g)).max()) for p, g in ref)
    assert worst <= GRAD_ATOL, worst
    assert max(float(np.abs(g).max()) for _, g in ref) > 100 * GRAD_ATOL
    back = convert.state_dict_to_flax(tenc.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, params))
    gather = SparseEncoder(layout="gather", **{
        k: v for k, v in ENC.items() if k != "max_columns_per_stage"})
    assert ({n: p.shape for n, p in gather.named_parameters()}
            == {n: p.shape for n, p in tenc.named_parameters()})


def test_column_encoder_bf16_equals_the_jax_package():
    """bf16 activations (the config's default): the BEV at ``BF16_RTOL``,
    float32 as JAX's; the gradients flow (remat on, the default)."""
    jenc, tenc, params, (feats, coords, valid) = _encoders("bfloat16")
    ref = np.asarray(jax.jit(lambda p, f: jenc.apply(
        {"params": p}, f, coords, valid))(params, feats))
    got = tenc(*(torch.from_numpy(a) for a in (feats, coords, valid)))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert np.abs(ref).max() > 0.1
    assert_close(got[0].permute(1, 2, 0).detach(), ref, "bf16 BEV",
                 BF16_RTOL)
    got.square().sum().backward()
    grads = [p.grad for p in tenc.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert tenc.conv_input.kernel.grad.abs().max() > 0


def test_column_layout_equals_gather_layout_and_jax_predict():
    """The tiny ``DynamicCenterPoint(encoder_layout="column")`` (float32
    activations, no remat: a forward; its budgets cut to 1,024 voxels, which the frame's 400
    points do not fill) on a frame within every budget: its head maps equal
    the port's gather layout's on the same weights, and so does its BEV map
    element for element (the same products summed in the same order), and
    its maps and their decode (``predict``) the JAX package's."""
    cfg = dataclasses.replace(jcp.tiny_centerpoint_config(), max_voxels=1024,
                              encoder_layout="column",
                              encoder_dtype="float32", encoder_remat=False)
    points, mask, *_ = cp_frame(cfg, seed=2, n_real=400)
    model = jcp.DynamicCenterPoint(cfg)
    tcfg = tcp.CenterPointConfig(**{f: getattr(cfg, f) for f in
                                    cfg.__dataclass_fields__})
    params = random_params(convert.state_dict_to_flax(
        tcp.DynamicCenterPoint(tcfg, device="cpu").state_dict()), seed=4)

    def predict(p):
        maps = model.apply({"params": p}, points, mask)
        return maps, jcph.decode(maps, cfg.voxel_size, cfg.pc_range,
                                 cfg.out_size_factor)

    maps, pred = jax.jit(predict)(params)
    sd = convert.flax_to_state_dict(params)
    pts, msk = torch.from_numpy(points), torch.from_numpy(mask)
    out, bev = {}, {}
    for layout in ("column", "gather"):
        t = tcp.DynamicCenterPoint(dataclasses.replace(
            tcfg, encoder_layout=layout), device="cpu")
        t.load_state_dict(sd)
        with torch.no_grad():
            out[layout] = t.eval()(pts, msk)
            vres = t.voxelize(pts, msk)
            vfeat, _ = t.vfe(pts, vres, cfg.max_voxels)
            bev[layout] = t.encoder(vfeat, vres.coords, vres.voxel_valid)
        rows = t.voxel_occupancy(pts, msk)
        assert all(r["occupied"] <= r["budget"] for r in rows), rows
    # the BEV maps element for element (channel c * D + z in both)
    assert bev["column"].shape == bev["gather"].shape
    assert_close(bev["column"], bev["gather"], "layouts' BEV", 1e-6)
    got = [x.numpy() for x in tcph.decode(
        out["column"], cfg.voxel_size, cfg.pc_range, cfg.out_size_factor)]
    for k in HEADS:
        assert_close(out["column"][k], maps[k], f"column {k}")
        assert_close(out["column"][k], out["gather"][k], f"layouts {k}",
                     1e-6)
    ref = [np.asarray(x) for x in pred]
    k = int(ref[3].sum())
    assert k > 0 and int(got[3].sum()) == k
    np.testing.assert_array_equal(got[2][:k], ref[2][:k])
    assert_close(got[1][:k], ref[1][:k], "scores")
    assert_close(got[0][:k], ref[0][:k], "boxes")
