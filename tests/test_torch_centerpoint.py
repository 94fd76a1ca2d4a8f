"""The port's DynamicCenterPoint held against the JAX package on the CPU at
``tiny_centerpoint_config()``: the encoder's BEV map, SECOND, SECONDFPN
(with its stride-2 transposed block), the head's maps, ``predict``, the
loss and every parameter's gradient, from one converted set of weights on
the same seeded frame. Every intermediate comes from one jitted JAX loss
and gradient (``capture_intermediates``).

Bars: float32 forward 2e-5 relative to each map's largest value; the
decode's valid entries equal in number and position, their boxes and
scores within the forward's bar (beyond the peaks the zeros tie, and
``torch.topk`` orders ties otherwise than ``lax.top_k``); per-parameter
gradients atol 1e-4.

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands out
the files with the most tests first, so a costly case in a large file would
start ahead of the suite's longest file."""
import jax
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.models import centerpoint as jcp
from objectcentricocccompletion_tpu.models import centerpoint_head as jcph
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import centerpoint as tcp
from objectcentricocccompletion_torch.models import centerpoint_head as tcph
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TINY = jcp.tiny_centerpoint_config()
FWD_RTOL = 2e-5
GRAD_ATOL = 1e-4
HEADS = ("heatmap", "reg", "height", "dim", "rot", "vel")


def random_params(shapes, seed):
    """flax-shaped params from numpy: kernels scaled by their fan-in
    (sparse kernels [K, Cin, Cout] by K * Cin), norm scales near 1, small
    biases; the heatmap bias at its prior (-2.19) plus noise."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        shift = -2.19 if path[-2].key == "heatmap_out" else 0.0
        return (shift + 0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray,
                                  jax.tree_util.tree_map_with_path(draw, shapes))


def cp_frame(cfg, seed, n_real=1500, num_boxes=4, max_gt=8):
    """A seeded frame inside ``cfg``'s range: uniform clutter, dense blobs
    at the boxes, points on the x = 0 and z = gz - 1 faces of the grid,
    some out of range (invalid) and padding. Returns numpy (points
    [max_points, 5], mask, boxes [max_gt, 7], labels, valid)."""
    rng = np.random.RandomState(seed)
    lo = np.asarray(cfg.pc_range[:3])
    hi = np.asarray(cfg.pc_range[3:])
    ctr = rng.uniform(lo + 1.5, hi - 1.5, (num_boxes, 3))
    size = np.abs(rng.normal([2.0, 4.0, 1.6], 0.3, (num_boxes, 3)))
    yaw = rng.uniform(-np.pi, np.pi, (num_boxes, 1))
    pts = rng.uniform(lo, hi, (n_real, 3))
    blob = ctr[rng.randint(num_boxes, size=n_real // 3)]
    pts[: n_real // 3] = np.clip(
        blob + rng.normal(0, 0.8, (n_real // 3, 3)), lo, hi - 1e-3)
    pts[-60:-30, 0] = lo[0]                 # voxel x = 0
    pts[-30:, 2] = hi[2] - 1e-3             # voxel z = gz - 1
    pts[-90:-60, 1] += 3 * (hi[1] - lo[1])  # out of range
    points = np.zeros((cfg.max_points, 5), np.float32)
    points[:n_real, :3] = pts
    points[:n_real, 3:] = rng.rand(n_real, 2)
    mask = np.arange(cfg.max_points) < n_real
    boxes = np.zeros((max_gt, 7), np.float32)
    boxes[:num_boxes] = np.concatenate([ctr, size, yaw], -1)
    labels = np.zeros((max_gt,), np.int32)
    valid = np.arange(max_gt) < num_boxes
    return points, mask, boxes, labels, valid


def torch_model(params, cfg=TINY):
    model = tcp.DynamicCenterPoint(tcp.CenterPointConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}),
        device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(params))
    return model.eval()


def param_tree(cfg=TINY):
    """The flax tree of ``cfg``'s model as ``convert`` writes it for the
    port's (its shapes without tracing the JAX ``init``, which costs
    seconds)."""
    return convert.state_dict_to_flax(tcp.DynamicCenterPoint(
        tcp.CenterPointConfig(**{f: getattr(cfg, f)
                                 for f in cfg.__dataclass_fields__}),
        device="cpu").state_dict())


def assert_close(got, ref, what, rtol=FWD_RTOL):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), 1.0)
    assert err <= rtol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def reference():
    """Params, the frame, and from one jitted JAX ``loss`` with its
    gradient: the head's maps, every module's output, the losses and the
    gradients. One GT box lies outside the grid."""
    points, mask, boxes, labels, valid = cp_frame(TINY, seed=0)
    boxes[1, :2] = (9.5, -8.0)
    model = jcp.DynamicCenterPoint(TINY)
    params = random_params(param_tree(), seed=1)

    def loss_fn(p):
        losses, state = model.apply(
            {"params": p}, points, mask, boxes, labels, valid,
            method=model.loss, capture_intermediates=True,
            mutable=["intermediates"])
        return losses["loss"], (losses, state["intermediates"])

    (_, (losses, inter)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    inter, losses, grads = jax.tree_util.tree_map(np.asarray,
                                                  (inter, losses, grads))
    frame = (points, mask, boxes, labels, valid)
    return params, frame, inter["head"]["__call__"][0], inter, losses, grads


def test_encoder_bev_equals_the_jax_package(reference):
    params, (points, mask, *_), _, inter, *_ = reference
    model = torch_model(params)
    pts, msk = torch.from_numpy(points), torch.from_numpy(mask)
    with torch.no_grad():
        vres = model.voxelize(pts, msk)
        vfeat, _ = model.vfe(pts, vres, TINY.max_voxels)
        assert_close(vfeat, inter["vfe"]["__call__"][0][0], "vfe")
        bev = model.encoder(vfeat, vres.coords, vres.voxel_valid)
    ref = inter["encoder"]["__call__"][0]             # [gx, gy, D * C]
    assert np.abs(ref).max() > 0.1
    assert_close(bev[0].permute(1, 2, 0), ref, "encoder BEV")


def test_second_fpn_and_head_equal_the_jax_package(reference):
    """SECOND's two stages (the second at stride 2), SECONDFPN's 1x1 and
    stride-2 transposed blocks, and the head's six maps, each fed the JAX
    package's input."""
    params, _, preds, inter, *_ = reference
    model = torch_model(params)
    bev = torch.tensor(inter["encoder"]["__call__"][0]).permute(
        2, 0, 1)[None]
    with torch.no_grad():
        feats = model.backbone(bev)
        for f, ref in zip(feats, inter["backbone"]["__call__"][0]):
            assert_close(f[0].permute(1, 2, 0), ref, "SECOND")
        assert feats[1].shape[-1] * 2 == feats[0].shape[-1]
        fpn_in = [torch.tensor(r).permute(2, 0, 1)[None]
                  for r in inter["backbone"]["__call__"][0]]
        fused = model.neck(fpn_in)
        assert_close(fused[0].permute(1, 2, 0), inter["neck"]["__call__"][0],
                     "SECONDFPN")
        head_in = torch.tensor(inter["neck"]["__call__"][0]).permute(
            2, 0, 1)[None]
        out = model.head(head_in)
    for k in HEADS:
        assert_close(out[k], preds[k], f"head {k}")


def test_forward_and_predict_equal_the_jax_package(reference):
    params, (points, mask, *_), preds, *_ = reference
    model = torch_model(params)
    pts, msk = torch.from_numpy(points), torch.from_numpy(mask)
    with torch.no_grad():
        out = model(pts, msk)
        for k in HEADS:
            assert_close(out[k], preds[k], f"forward {k}")
        got = [x.numpy() for x in model.predict(pts, msk)]
    # the decode on the same maps, both packages
    ref = [np.asarray(x) for x in jax.jit(lambda p: jcph.decode(
        p, TINY.voxel_size, TINY.pc_range, TINY.out_size_factor))(preds)]
    n = len(ref[0])
    assert [x.shape[0] for x in got] == [n] * 4
    assert got[3].sum() == ref[3].sum() > 0
    # valid entries come first (descending scores), in the same order
    k = int(ref[3].sum())
    assert got[3][:k].all() and ref[3][:k].all()
    np.testing.assert_array_equal(got[2][:k], ref[2][:k])
    assert_close(got[1][:k], ref[1][:k], "scores")
    assert_close(got[0][:k], ref[0][:k], "boxes")
    # a 3-class heatmap: the class is idx % ncls of the HWC flattening
    rng = np.random.RandomState(3)
    maps = {k: rng.randn(4, 4, c).astype(np.float32) for k, c in zip(
        HEADS, (3, 2, 1, 3, 2, 2))}
    got = tcph.decode({k: torch.from_numpy(v) for k, v in maps.items()},
                      TINY.voxel_size, TINY.pc_range, TINY.out_size_factor,
                      max_out=20)
    ref = jax.jit(lambda p: jcph.decode(
        p, TINY.voxel_size, TINY.pc_range, TINY.out_size_factor,
        max_out=20))(maps)
    k = int(np.asarray(ref[3]).sum())
    assert 0 < k == int(got[3].sum())
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy()[:k], np.asarray(b)[:k],
                                   rtol=1e-6, atol=1e-6)


def test_loss_and_gradients_equal_the_jax_package(reference):
    """The losses within 2e-5 relative, and every parameter's gradient of
    the loss, over the whole tree (VFE, the sparse kernels, SECOND,
    SECONDFPN's transposed block, the head), at atol 1e-4."""
    params, frame, _, _, losses, grads = reference
    model = torch_model(params).train()
    got = model.loss(*(torch.tensor(x) for x in frame))
    got["loss"].backward()
    for k in ("loss_heatmap", "loss_bbox", "loss"):
        assert abs(float(got[k].detach()) - float(losses[k])) <= 2e-5 * abs(
            float(losses[k])), k
    tree = convert.state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})
    flat_ref = jax.tree_util.tree_flatten_with_path(grads)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat_ref) == len(flat_got) == 166
    worst = {jax.tree_util.keystr(p): float(np.abs(flat_got[p] - g).max())
             for p, g in flat_ref}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    print(f"gradients: worst {top}")
    assert top[0][1] <= GRAD_ATOL, top
    assert max(float(np.abs(g).max()) for _, g in flat_ref) > 100 * GRAD_ATOL
