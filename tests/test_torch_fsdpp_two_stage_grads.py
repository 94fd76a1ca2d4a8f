"""Two-stage FSD++'s window step (the default ``FSDPPConfig()``'s kind) in
the port against the jitted JAX ``make_seq_train_step`` on the CPU, at
``tiny_fsdpp_config()``: the mean losses, every parameter's gradient and
the state handed to the next window.

The JAX two-stage window step traces and compiles in 35-60 s here, so this
file is ``slow`` (outside tier 1, as the 300-step twins):

    python -m pytest tests/test_torch_fsdpp_two_stage_grads.py -m slow

The window holds the three frames of ``test_torch_fsdpp.py``'s sequence
with its incoming state and weights, stage 1's boxes set by
``box_proposals`` so that stage 2 has positives, and the seed augmentation
fed JAX's own uniform draws. The JAX step runs with an optimizer whose
state is the gradients (``test_torch_fsdpp_train.py::capture_grads``).

Stage 1's grouping is discrete. On these inputs JAX's jitted forward alone
gives the port's losses, but the step's gradient graph, which XLA fuses
otherwise, groups otherwise (its ``loss_center`` 2.1340 against 2.1313). So the test captures the step's
groupings from a copy of ``make_seq_train_step``'s loss function with
``capture_intermediates`` (its losses equal the step's bit for bit,
asserted) and feeds them to the port's step (``overrides``, as
``record`` hands them on); the pool is the port's own.

Bars: losses 2e-5 relative; per-parameter gradients atol 1e-4 times
max(1, the tensor's largest |gradient|); the carried state's discrete parts
exactly, its floats within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.models import fsd_two_stage as jfts
from objectcentricocccompletion_tpu.models import fsdpp as jpp
from objectcentricocccompletion_tpu.ops import seeds as jseeds
from objectcentricocccompletion_tpu.training import seq_trainer as jst
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import fsd as tfsd
from objectcentricocccompletion_torch.models import fsd as tfsd
from objectcentricocccompletion_torch.ops import seeds as tseeds
from objectcentricocccompletion_torch.training import seq_trainer as tst
from objectcentricocccompletion_torch.training.optim import make_optimizer
from tests.test_torch_create_data import assert_same
from tests.test_torch_fsd_loss import GRAD_ATOL, LOSS_RTOL
from tests.test_torch_fsdpp import (TINY, assert_state_equal, box_proposals,
                                    incoming_state, init_params,
                                    sequence_frames, to_torch, torch_fsdpp,
                                    torch_state)
from tests.test_torch_fsdpp_train import capture_grads
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

# the sequence's three frames in one window (two of them give stage 2 no
# positive under the seed augmentation)
WINDOW = 3


def jax_noise(rng, capacity):
    """The uniforms that the JAX step draws for each frame of the window
    from ``rng`` (as ``test_torch_fsdpp_train.py::jax_noise``, for this
    window)."""
    out = []
    for w in range(WINDOW):
        r_drop, r_fp = jax.random.split(jax.random.fold_in(rng, w))
        r_copy, r_shift = jax.random.split(r_fp)
        out.append(tseeds.SeedNoise(*(torch.tensor(np.asarray(u)) for u in (
            jax.random.uniform(r_drop, (capacity,)),
            jax.random.uniform(r_copy, (capacity,)),
            jax.random.uniform(r_shift, (capacity, 2))))))
    return out


def jax_step_with_groupings(params, window, state, rng):
    """``make_seq_train_step``'s loss and gradient with stage 1's grouping
    of each frame captured (``capture_intermediates`` on ``group``): the
    step's loss function, copied, jitted with the gradient. Returns (the
    losses, the port's ``(Grouping, None)`` per frame; the pool is left to
    the port)."""
    model = jpp.FSDPP(TINY)

    def loss_fn(p, window, m, rng):
        losses, groups, chain = [], [], None
        for w in range(WINDOW):
            r_drop, r_fp = jax.random.split(jax.random.fold_in(rng, w))
            s = m.seeds
            keep = jseeds.seed_dropout_step(
                *(chain if chain is not None else (None,) * 3), s.boxes,
                s.valid, r_drop, TINY.seed_drop_rate)
            chain = (s.boxes, s.valid, keep)
            seeds_in = jseeds.seed_fp_insertion(
                jseeds.Seeds(s.boxes, s.labels, s.scores, keep), r_fp,
                TINY.seed_fp_rate)
            merged = jnp.concatenate([window.points[w], m.memory], 0)
            (m, out), inter = model.apply(
                {"params": p}, m, window.points[w], window.points_mask[w],
                seeds_in, mutable=["intermediates"],
                capture_intermediates=lambda mdl, name: (
                    mdl.name == "stage1" and name == "group"))
            groups.append(inter["intermediates"]["fsd"]["stage1"]["group"][0])
            losses.append(jfts.two_stage_loss(
                out, merged, window.gt_boxes[w], window.gt_labels[w],
                window.gt_valid[w]))
        aux = {k: sum(l[k] for l in losses) / WINDOW for k in losses[0]}
        return sum(l["loss"] for l in losses) / WINDOW, (aux, groups)

    (_, (aux, groups)), _ = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, window, state, rng)
    aux, groups = jax.tree_util.tree_map(np.asarray, (aux, groups))
    return aux, [(tfsd.Grouping(*to_torch(g)), None) for g in groups]


@pytest.mark.slow
def test_two_stage_window_step_gradients_equal_the_jax_step():
    frames = sequence_frames(TINY, seed=11)
    state = incoming_state(TINY, frames[0], seed=12)
    params = box_proposals(init_params(TINY, seed=13))
    window = jst.SeqWindow(*(np.stack(a) for a in zip(*frames)))
    rng = jax.random.PRNGKey(5)
    jstep = jst.make_seq_train_step(jpp.FSDPP(TINY), capture_grads(), WINDOW)
    _, grads, new, aux = jax.tree_util.tree_map(np.asarray, jstep(
        params, capture_grads().init(params), window, state, rng))
    batch = tst.SeqWindow(*(torch.tensor(a) for a in window[:5]))
    noise = jax_noise(rng, TINY.max_seeds)

    caux, groupings = jax_step_with_groupings(params, window, state,
                                                      rng)
    # the copy's forward is the step's, bit for bit
    assert_same(caux, {k: v for k, v in aux.items() if k != "grad_norm"})
    model = torch_fsdpp(params, TINY)
    # no clip: the gradients are compared as the JAX step takes them
    opt, schedule = make_optimizer(model.named_parameters(), 1e-5, 10)
    step_fn = tst.make_seq_train_step(model, opt, schedule, WINDOW,
                                      grad_clip=float("inf"))
    runs = [(model, *step_fn(0, batch, torch_state(state), noise=noise,
                             overrides=groupings))]

    flat_ref = jax.tree_util.tree_flatten_with_path(grads)[0]
    for model, got_state, got in runs:
        assert set(got) == set(aux)
        for k, ref in aux.items():
            ref = float(ref)
            assert abs(float(got[k]) - ref) <= LOSS_RTOL * max(abs(ref),
                                                               1e-3), \
                (k, float(got[k]), ref)
        assert float(aux["num_pos_rois2"]) > 0 and \
            float(aux["loss_reg2"]) > 0
        assert_state_equal(got_state, new, "carried state")
        tree = convert.state_dict_to_flax(
            {n: p.grad for n, p in model.named_parameters()})
        flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert len(flat_ref) == len(flat_got)
        worst = sorted(((float(np.abs(flat_got[p] - g).max())
                         / (GRAD_ATOL * max(1.0, float(np.abs(g).max()))),
                         jax.tree_util.keystr(p)) for p, g in flat_ref),
                       reverse=True)[:3]
        print(f"two-stage window step gradients: worst share of the bar "
              f"{worst}")
        assert worst[0][0] <= 1.0, worst
    assert max(float(np.abs(g).max()) for _, g in flat_ref) > 1.0
