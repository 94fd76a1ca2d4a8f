"""CenterPoint's targets and losses, and the converter's CenterPoint tree,
in the port held against the JAX package on the CPU at
``tiny_centerpoint_config()`` (the model's gradients are in
``test_torch_centerpoint.py``).

Bars: targets and losses within 2e-5 relative (integer centres and masks
equal exactly); the converter's round trip exact.

A file of at most four tests (pytest-xdist's ``--dist loadfile``; see
``test_torch_centerpoint.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from objectcentricocccompletion_tpu.models import centerpoint as jcp
from objectcentricocccompletion_tpu.models import centerpoint_head as jcph
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import centerpoint as tcp
from objectcentricocccompletion_torch.models import centerpoint_head as tcph
from tests.test_torch_centerpoint import TINY, random_params, torch_model
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

def _boxes(seed, m=6):
    """Boxes of three classes (class 2 left empty by the labels of the
    valid ones), one centre outside the 4 x 4 grid, one padded row."""
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([
        rng.uniform(-6, 6, (m, 2)), rng.uniform(-1, 2, (m, 1)),
        np.abs(rng.normal([2, 4, 1.6], 0.5, (m, 3))),
        rng.uniform(-np.pi, np.pi, (m, 1)), rng.normal(0, 1, (m, 2))],
        -1).astype(np.float32)
    boxes[1, :2] = (9.5, -8.0)         # outside the grid
    labels = np.asarray([0, 1, 0, 1, 0, 2][:m], np.int32)
    valid = np.ones(m, bool)
    valid[-1] = False                  # the only class-2 box is padding
    return boxes, labels, valid


def test_targets_and_losses_equal_the_jax_package():
    H = W = 4
    for ncls, width in ((3, 9), (1, 7)):
        boxes, labels, valid = _boxes(ncls)
        boxes = boxes[:, :width]
        if ncls == 1:
            labels = np.zeros_like(labels)
        ref = [np.asarray(x) for x in jax.jit(
            lambda b, lab, v: jcph.make_targets(
                b, lab, v, (H, W), ncls, TINY.voxel_size, TINY.pc_range,
                TINY.out_size_factor))(boxes, labels, valid)]
        got = [x.numpy() for x in tcph.make_targets(
            torch.tensor(boxes), torch.tensor(labels), torch.tensor(valid),
            (H, W), ncls, TINY.voxel_size, TINY.pc_range,
            TINY.out_size_factor)]
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-5)
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=2e-5)
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_array_equal(got[3], ref[3])
        assert not ref[3][1] and not ref[3][-1] and ref[3][0]
        if ncls == 3:
            assert (ref[0][..., 2] == 0).all() and ref[0][..., 1].max() > 0
        rng = np.random.RandomState(ncls)
        preds = {k: rng.randn(H, W, c).astype(np.float32) for k, c in zip(
            ("heatmap", "reg", "height", "dim", "rot", "vel"),
            (ncls, 2, 1, 3, 2, 2))}
        jl = jax.jit(lambda p, b, lab, v: jcph.center_head_loss(
            p, b, lab, v, TINY.voxel_size, TINY.pc_range,
            TINY.out_size_factor))(preds, boxes, labels, valid)
        tl = tcph.center_head_loss(
            {k: torch.tensor(v) for k, v in preds.items()},
            torch.tensor(boxes), torch.tensor(labels), torch.tensor(valid),
            TINY.voxel_size, TINY.pc_range, TINY.out_size_factor)
        for k in ("loss_heatmap", "loss_bbox", "loss"):
            assert abs(float(tl[k]) - float(jl[k])) <= 2e-5 * abs(
                float(jl[k])), k
        hm = ref[0]
        np.testing.assert_allclose(
            float(tcph.gaussian_focal_loss(torch.tensor(preds["heatmap"]),
                                           torch.tensor(hm))),
            float(jax.jit(jcph.gaussian_focal_loss)(preds["heatmap"], hm)),
            rtol=2e-5)
    lw = np.asarray([[10.0, 3.0, 0.0], [5.0, 2.0, 0.0]], np.float32)
    np.testing.assert_allclose(
        tcph.gaussian_radius(*torch.tensor(lw)).numpy(),
        np.asarray(jax.jit(jcph.gaussian_radius)(*lw)), rtol=1e-6)


def test_converter_round_trips_the_centerpoint_tree():
    """The tiny tree round-trips exactly through a loaded port model; the
    full-width tree's names and shapes (``jax.eval_shape``, no compute)
    load into ``DynamicCenterPoint(CenterPointConfig())``, strictly."""
    for cfg in (TINY, jcp.CenterPointConfig()):
        pts = jax.ShapeDtypeStruct((cfg.max_points, 5), jnp.float32)
        msk = jax.ShapeDtypeStruct((cfg.max_points,), jnp.bool_)
        shapes = jax.eval_shape(jcp.DynamicCenterPoint(cfg).init,
                                jax.random.PRNGKey(0), pts, msk)["params"]
        if cfg is TINY:
            params = random_params(shapes, seed=2)
            model = torch_model(params)
            back = convert.state_dict_to_flax(model.state_dict())
            flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
            flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
            assert len(flat_a) == len(flat_b) == 166
            for path, leaf in flat_a:
                np.testing.assert_array_equal(flat_b[path], leaf)
            continue
        zeros = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)
        sd = convert.flax_to_state_dict(zeros)
        model = tcp.DynamicCenterPoint(tcp.CenterPointConfig(),
                                       device="cpu")
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert len(sd) == 165
        # the transposed block: torch [in, out, kh, kw], taps mirrored
        k = np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(2, 2, 3, 4)
        w = convert.flax_to_state_dict({"neck": {"deblock1": {"kernel": k}}})
        np.testing.assert_array_equal(w["neck.deblock1.weight"][1, 2].numpy(),
                                      k[::-1, ::-1, 1, 2])


def test_column_layout_builds_the_gather_layouts_parameters():
    """``encoder_layout="column"`` at full width builds with the gather
    layout's parameter names and shapes (one tree for both layouts), its
    encoder in the config's bf16 with remat, the gather one in float32."""
    shapes = {}
    for layout in ("gather", "column"):
        model = tcp.DynamicCenterPoint(tcp.CenterPointConfig(
            encoder_layout=layout), device="cpu")
        shapes[layout] = {n: tuple(p.shape)
                          for n, p in model.named_parameters()}
        assert model.encoder.layout == layout
        assert model.encoder.dtype == (torch.bfloat16 if layout == "column"
                                       else torch.float32)
    assert shapes["column"] == shapes["gather"]
    assert model.encoder.remat_blocks
    assert model.encoder.max_columns_per_stage == (60000, 30000, 15000,
                                                   7500)
