"""Two-stage FSD in the port against the JAX package on the CPU at
``tiny_two_stage_config()``: the forward (stage 1 fed the JAX forward's
own grouping), the pool (the first in-box points in scan order; what the
masked slots hold does not reach the output), ``two_stage_loss`` with the
corner loss and every parameter's gradient, and bf16 against float32 at the
JAX tests' bar.

Bars: float32 forward 2e-5 relative to each output's largest value; losses
2e-5 relative; per-parameter gradients atol 1e-4 times max(1, the tensor's
largest |gradient|) (``test_torch_fsd_loss.py``). The stage-2
classification reaches stage 1 through the IoU of the proposals with the
GT, whose shoelace areas cancel on corners about 10 m out: the last-bit
differences of XLA's and torch's sin and cos there give the soft labels a
relative difference near 1e-5, and the stage-1 gradients that carry it
reach 34.

A file of at most four tests (pytest-xdist's ``--dist loadfile``; see
``test_torch_fsd.py``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.models import fsd_two_stage as jts
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import fsd_two_stage as tts
from tests.test_torch_fsd import (assert_bf16_tracks_float32, assert_close,
                                  bf16_frame, compare_outputs, fsd_frame,
                                  port_config, random_params)
from tests.test_torch_fsd_loss import (assert_losses_and_grads,
                                       grouping_of, jax_loss_and_grads)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TINY2 = jts.tiny_two_stage_config()
STAGE2_KEYS = ("cls2", "bbox2", "refined_boxes", "rois")


def port_two_stage_config(cfg):
    return dataclasses.replace(
        tts.tiny_two_stage_config(), fsd=port_config(cfg.fsd),
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__
           if f != "fsd"})


def torch_two_stage(params):
    model = tts.TwoStageFSD(port_two_stage_config(TINY2), device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(params))
    return model


def param_tree():
    """The flax tree of ``TINY2``'s model as ``convert`` writes it for the
    port's (its shapes without tracing the JAX ``init``, which costs
    seconds)."""
    return convert.state_dict_to_flax(tts.TwoStageFSD(
        port_two_stage_config(TINY2), device="cpu").state_dict())


@pytest.fixture(scope="module")
def reference():
    """A frame whose GT boxes sit on four of the stage-1 proposals (cars
    and a pedestrian, moved by a few cm), so that stage 2 has positives
    for its regression and corner losses; the params; the JAX losses,
    intermediates and gradients; the JAX forward on the frame and its
    stage-1 grouping (one jitted forward serves both: the GT does not
    reach it)."""
    frame = list(fsd_frame(TINY2.fsd, seed=7))
    model = jts.TwoStageFSD(TINY2)
    params = random_params(param_tree(), seed=8)
    params["stage1"]["seg_head"]["Dense_1"]["kernel"] *= 0.1
    out, state = jax.jit(lambda p, x, m: model.apply(
        {"params": p}, x, m, mutable=["intermediates"],
        capture_intermediates=lambda mdl, name: (
            mdl.name == "stage1" and name == "group")))(
        params, frame[0], frame[1])
    out = jax.tree_util.tree_map(np.asarray, out)
    grouping = grouping_of(jax.tree_util.tree_map(
        np.asarray, state["intermediates"]["stage1"]))
    ok = np.asarray(out["roi_nonempty"])
    cls = np.asarray(out["cluster_class"])
    pick = ([int(i) for i in np.nonzero(ok & (cls == 0))[0][:3]]
            + [int(i) for i in np.nonzero(ok & (cls == 1))[0][:1]])
    assert len(pick) == 4, ok
    boxes = np.zeros_like(frame[2])
    boxes[:4] = np.asarray(out["rois"])[pick] + np.float32(
        [0.05, -0.04, 0.02, 0.03, -0.05, 0.02, 0.04])
    frame[2:] = [boxes, np.int32([0, 0, 0, 1] + [0] * 4),
                 np.arange(len(boxes)) < 4]
    losses, inter, grads = jax_loss_and_grads(
        model, jts.two_stage_loss, params, tuple(frame), stage1="stage1")
    return params, tuple(frame), losses, inter, grads, (out, grouping)


def test_forward_and_pool_equal_the_jax_package(reference):
    params, (points, mask, *_), *_, (out, grouping) = reference
    tmodel = torch_two_stage(params).eval()
    pts, msk = torch.from_numpy(points), torch.from_numpy(mask)
    with torch.no_grad():
        got = tmodel(pts, msk, grouping)
    compare_outputs(got, out, "two-stage stage 1")
    np.testing.assert_array_equal(got["roi_nonempty"].numpy(),
                                  out["roi_nonempty"])
    assert 4 <= out["roi_nonempty"].sum() < out["roi_nonempty"].size
    for k in STAGE2_KEYS:
        assert_close(got[k], out[k], f"two-stage {k}")

    # the pool: the first in-box points of each RoI in scan order, then
    # slots that are not valid (JAX's hold other points there)
    inside = torch.rand(5, 300, generator=torch.Generator().manual_seed(0)) \
        < torch.tensor([[0.0], [0.01], [0.1], [0.5], [1.0]])
    idx, ok = tts.first_in_box(inside, 16)
    for r in range(5):
        cols = torch.nonzero(inside[r])[:16, 0]
        assert torch.equal(idx[r, :len(cols)], cols)
        assert ok[r].sum() == len(cols) and ok[r, :len(cols)].all()

    # what the masked slots hold does not reach the output: slots past a
    # RoI's in-box points read index 0; read the last point instead
    idx, pmask = tmodel.select_points(pts, msk, got["rois"])
    assert (~pmask & got["roi_nonempty"][:, None]).any()
    other = torch.where(pmask, idx, pts.shape[0] - 1)
    with torch.no_grad():
        moved = tmodel(pts, msk, grouping, (other, pmask))
    for k in STAGE2_KEYS + ("roi_nonempty",):
        assert torch.equal(moved[k], got[k]), k


def test_two_stage_loss_and_gradients_equal_the_jax_package(reference):
    """Every loss entry of both stages (the corner loss and the stage-2
    regression among them, on positives) and every parameter's
    gradient."""
    params, frame, losses, inter, grads, _ = reference
    assert float(losses["num_pos_rois2"]) >= 2
    assert float(losses["loss_corner2"]) > 0
    model = torch_two_stage(params).train()
    pts, msk, *gt = (torch.from_numpy(a) for a in frame)
    out = model(pts, msk, grouping_of(inter["stage1"]))
    got = tts.two_stage_loss(out, pts, *gt)
    assert_losses_and_grads(got, losses, model, grads,
                            len(jax.tree_util.tree_leaves(params)))


def test_bf16_losses_track_float32():
    def build(dtype):
        cfg = port_two_stage_config(TINY2)
        cfg = dataclasses.replace(cfg, fsd=dataclasses.replace(
            cfg.fsd, compute_dtype=dtype))
        return tts.TwoStageFSD(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))

    assert_bf16_tracks_float32(build, bf16_frame(1, 1))
