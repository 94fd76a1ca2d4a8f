"""FSD's losses and every parameter's gradient in the port against the JAX
package on the CPU: ``fsd_loss`` of FSD (``tiny_fsd_config()``) and of
FSDv2, from one converted set of weights on the same seeded frame. The
port's forward is fed the JAX forward's own grouping (captured from one
jitted JAX loss and gradient), so that both differentiate the same
clusters.

Bars: losses 2e-5 relative; per-parameter gradients atol 1e-4 times
max(1, the tensor's largest |gradient|), the bar of the repository's
gradient transplant (``tests/test_grad_transplant_parity.py``). The
single-stage gradients are O(1) and meet 1e-4 itself; two-stage FSD's reach
34, because the stage-2 losses reach stage 1 through the proposals' IoU
with the GT (``test_torch_fsd_two_stage.py``).

A file of at most four tests (pytest-xdist's ``--dist loadfile``; see
``test_torch_fsd.py``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.models import fsd as jfsd
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import fsd as tfsd
from tests.test_torch_fsd import (STAGES, TINY, fsd_frame, init_params,
                                  torch_model)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

LOSS_RTOL = 2e-5
GRAD_ATOL = 1e-4


def capture(name_of_stage1=None):
    """``capture_intermediates`` filter: the stages of the top module (or
    of its submodule ``name_of_stage1``)."""
    return lambda mdl, name: name in STAGES and mdl.name == name_of_stage1


def jax_loss_and_grads(model, loss, params, frame, stage1=None):
    """One jitted JAX loss with its gradient -> (losses, intermediates,
    gradients), numpy."""
    def loss_fn(p, points, mask, boxes, labels, valid):
        out, state = model.apply({"params": p}, points, mask,
                                 mutable=["intermediates"],
                                 capture_intermediates=capture(stage1))
        losses = loss(out, points, boxes, labels, valid)
        return losses["loss"], (losses, state["intermediates"])

    (_, (losses, inter)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, *frame)
    return jax.tree_util.tree_map(np.asarray, (losses, inter, grads))


def grouping_of(inter):
    return tfsd.Grouping(*(torch.tensor(a) for a in inter["group"][0]))


def assert_losses_and_grads(got, losses, model, grads, n_params):
    for k, ref in losses.items():
        ref = float(ref)
        assert abs(float(got[k].detach()) - ref) <= LOSS_RTOL * max(
            abs(ref), 1e-3), (k, float(got[k]), ref)
    got["loss"].backward()
    tree = convert.state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})
    flat_ref = jax.tree_util.tree_flatten_with_path(grads)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat_ref) == len(flat_got) == n_params
    worst = {jax.tree_util.keystr(p): (
        float(np.abs(flat_got[p] - g).max())
        / (GRAD_ATOL * max(1.0, float(np.abs(g).max())))) for p, g in flat_ref}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    print(f"gradients: worst share of the bar {top}")
    assert top[0][1] <= 1.0, top
    assert max(float(np.abs(g).max()) for _, g in flat_ref) > 100 * GRAD_ATOL


@pytest.mark.parametrize("clustering", [True, False])
def test_fsd_loss_and_gradients_equal_the_jax_package(clustering):
    """Every loss entry (segmentation, votes, the per-task focal and L1
    losses, the counts) and every parameter's gradient, FSD and FSDv2."""
    cfg = dataclasses.replace(TINY, use_clustering=clustering)
    frame = fsd_frame(cfg, seed=5)
    if not clustering:
        # no clutter: FSDv2's first voxels in key order then lie in boxes
        frame[1][:800] = False
    params = init_params(cfg, seed=6)
    # short votes, so that clusters stay in their boxes: positives for the
    # regression losses
    params["seg_head"]["Dense_1"]["kernel"] *= 0.1
    model = jfsd.FSD(cfg)
    losses, inter, grads = jax_loss_and_grads(
        model, lambda out, *a: jfsd.fsd_loss(out, *a, cfg), params, frame)
    assert float(losses["num_pos_clusters"]) >= 3
    assert float(losses["num_fg_points"]) > 100

    tmodel = torch_model(params, cfg).train()
    pts, msk, *gt = (torch.from_numpy(a) for a in frame)
    out = tmodel(pts, msk, grouping_of(inter) if clustering else None)
    got = tfsd.fsd_loss(out, pts, *gt, tmodel.cfg)
    n = len(jax.tree_util.tree_leaves(params))
    assert_losses_and_grads(got, losses, tmodel, grads, n)
