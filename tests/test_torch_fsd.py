"""The port's FSD held against the JAX package on the CPU at
``tiny_fsd_config()``, stage by stage, from one converted set of weights on
the same seeded frame. One jitted JAX forward captures the output of
``segment``, ``group`` and ``__call__``; the port's ``group`` on JAX's own
logits and votes must give the same foreground indices, cluster labels and
cluster validity exactly, and the port's cluster forward, fed that
grouping, must give the JAX forward's outputs. FSDv2 the same way, and
bf16 against float32 in the port at the JAX tests' own bar
(``tests/test_fsd.py``).

Bars: float32 forward 2e-5 relative to each output's largest value.

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands out
the files with the most tests first, so a costly case in a large file would
start ahead of the suite's longest file."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.models import fsd as jfsd
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import fsd as tfsd
from tests.test_fsd import make_fsd_frame
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TINY = jfsd.tiny_fsd_config()
FWD_RTOL = 2e-5
OUT_KEYS = ("cls", "reg_tasks", "boxes_tasks", "boxes", "cluster_centers")
STAGES = ("segment", "group", "__call__")


def port_config(cfg):
    return tfsd.FSDConfig(**{f: getattr(cfg, f)
                             for f in cfg.__dataclass_fields__})


def random_params(shapes, seed):
    """flax-shaped params from numpy: every kernel (rank >= 2) scaled by
    its fan-in, norm scales near 1, small biases."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        if path[-1].key == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))


def fsd_frame(cfg, seed, num_boxes=3):
    return tuple(np.array(a) for a in make_fsd_frame(
        cfg, seed=seed, num_boxes=num_boxes, classes=[0, 1, 2][:num_boxes]))


def torch_model(params, cfg):
    model = tfsd.FSD(port_config(cfg), device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(params))
    return model.eval()


def jax_capture(cfg, params, points, mask):
    """One jitted JAX forward: the outputs of ``segment``, ``group`` and
    the forward (numpy)."""
    model = jfsd.FSD(cfg)

    def run(p, points, mask):
        return model.apply({"params": p}, points, mask, mutable=[
            "intermediates"], capture_intermediates=(
                lambda mdl, name: mdl is not None and name in STAGES
                and mdl.name is None))

    out, state = jax.jit(run)(params, points, mask)
    inter = state["intermediates"]
    return jax.tree_util.tree_map(np.asarray, (
        out, {k: inter[k][0] for k in ("segment", "group") if k in inter}))


def init_params(cfg, seed):
    """Seeded flax params over the tree that ``convert`` writes for the
    port's model (tracing the JAX ``init`` for its shapes costs
    seconds)."""
    return random_params(convert.state_dict_to_flax(tfsd.FSD(
        port_config(cfg), device="cpu").state_dict()), seed)


def assert_close(got, ref, what, rtol=FWD_RTOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), 1.0)
    assert err <= rtol * scale, (what, err, scale)


def compare_outputs(out, ref, what):
    np.testing.assert_array_equal(out["cluster_valid"].numpy(),
                                  ref["cluster_valid"], err_msg=what)
    np.testing.assert_array_equal(out["cluster_class"].numpy(),
                                  ref["cluster_class"], err_msg=what)
    for k in OUT_KEYS:
        assert_close(out[k].detach(), ref[k], f"{what} {k}")


@pytest.fixture(scope="module")
def reference():
    points, mask, *_ = fsd_frame(TINY, seed=4)
    params = init_params(TINY, seed=2)
    out, inter = jax_capture(TINY, params, points, mask)
    return params, points, mask, out, inter


def test_segment_and_group_equal_the_jax_package(reference):
    """``segment`` within the forward's bar; ``group`` on JAX's logits and
    votes equal to JAX's grouping: foreground indices, labels, centres."""
    params, points, mask, _, inter = reference
    model = torch_model(params, TINY)
    pts, msk = torch.from_numpy(points), torch.from_numpy(mask)
    with torch.no_grad():
        seg_logits, votes, pv, pfeat = model.segment(pts, msk)
    j_logits, j_votes, j_pv, j_pfeat = inter["segment"]
    assert_close(seg_logits, j_logits, "seg_logits")
    assert_close(votes, j_votes, "votes")
    assert_close(pfeat, j_pfeat, "per-point features")
    np.testing.assert_array_equal(pv.numpy(), j_pv)

    with torch.no_grad():
        got = model.group(pts, torch.from_numpy(j_logits),
                          torch.from_numpy(j_votes), torch.from_numpy(j_pv))
    fg_idx, fg_label, centers = inter["group"]
    np.testing.assert_array_equal(got.fg_idx.numpy(), fg_idx)
    np.testing.assert_array_equal(got.fg_label.numpy(), fg_label)
    np.testing.assert_array_equal(got.fg_centers.numpy(), centers)
    # a grouping worth comparing: clusters in every class, several points
    # each, some foreground points in none
    kc = TINY.max_clusters_per_class
    for k in range(TINY.num_classes):
        lab = fg_label[k][fg_label[k] >= 0]
        assert len(np.unique(lab)) >= 2 and len(lab) > 2 * len(
            np.unique(lab)), (k, lab)
        assert ((lab >= k * kc) & (lab < (k + 1) * kc)).all()
    assert (fg_label < 0).any()


def test_cluster_forward_equals_the_jax_forward(reference):
    """The SIR and the head over JAX's grouping, fed the port's own
    segmentation: every output within the forward's bar, the cluster
    validity exactly."""
    params, points, mask, out, inter = reference
    model = torch_model(params, TINY)
    pts, msk = torch.from_numpy(points), torch.from_numpy(mask)
    grouping = tfsd.Grouping(*(torch.from_numpy(a) for a in inter["group"]))
    with torch.no_grad():
        got = model.cluster_forward(pts, *model.segment(pts, msk), grouping)
    assert out["cluster_valid"].sum() >= 6
    compare_outputs(got, out, "fsd")
    # and the whole forward, which groups on its own logits
    with torch.no_grad():
        compare_outputs(model(pts, msk), out, "fsd forward")


def test_fsdv2_forward_equals_the_jax_package():
    cfg = dataclasses.replace(TINY, use_clustering=False)
    points, mask, *_ = fsd_frame(cfg, seed=2)
    params = init_params(cfg, seed=3)
    assert "sir" not in params and "mixer1" in params
    out, _ = jax_capture(cfg, params, points, mask)
    model = torch_model(params, cfg)
    with torch.no_grad():
        got = model(torch.from_numpy(points), torch.from_numpy(mask))
    # every class's slots fill: the budget's cut is exercised
    assert out["cluster_valid"].sum() == cfg.max_clusters
    compare_outputs(got, out, "fsdv2")
    for k in ("seg_logits", "votes"):
        assert_close(got[k], out[k], f"fsdv2 {k}")


def bf16_frame(seed, num_boxes):
    """The JAX bf16 tests' frame: 512 uniform points (400 valid) and
    ``num_boxes`` of a car and a pedestrian box."""
    rng = np.random.RandomState(seed)
    n = 512
    points = rng.uniform(-9, 9, (n, 5)).astype(np.float32)
    points[:, 2] = rng.uniform(-1.5, 2.0, n)
    mask = np.arange(n) < 400
    boxes = np.array([[1.0, 2.0, -0.5, 2.0, 4.5, 1.7, 0.3],
                      [-3.0, -2.0, -0.2, 0.8, 0.8, 1.7, 0.0]],
                     np.float32)[:num_boxes]
    labels = np.array([0, 1], np.int32)[:num_boxes]
    return [torch.from_numpy(a) for a in (
        points, mask, boxes, labels, np.ones(num_boxes, bool))]


def assert_bf16_tracks_float32(build, frame):
    """``build(dtype)``'s losses in bfloat16 compute against float32 at the
    JAX tests' bar: |a - b| <= 0.05 max(|a|, 1e-3) + 2e-2 per entry."""
    losses = {}
    for dtype in ("float32", "bfloat16"):
        with torch.no_grad():
            losses[dtype] = {k: float(v) for k, v in
                             build(dtype).loss(*frame).items()}
    for k, a in losses["float32"].items():
        b = losses["bfloat16"][k]
        assert np.isfinite(b), (k, b)
        assert abs(a - b) <= 0.05 * max(abs(a), 1e-3) + 2e-2, (k, a, b)


def test_bf16_losses_track_float32():
    """bf16 compute (float32 parameters, LayerNorm statistics, losses)
    against float32 in the port, on the JAX test's frame and bar."""
    def build(dtype):
        cfg = dataclasses.replace(port_config(TINY), compute_dtype=dtype)
        return tfsd.FSD(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))

    assert_bf16_tracks_float32(build, bf16_frame(0, 2))
