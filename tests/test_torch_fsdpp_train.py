"""FSD++ with single-stage FSD in the port against the JAX package on the
CPU at ``tiny_fsdpp_config(two_stage=False)`` cut to one class (``TINY1``):
a 3-frame sequence (as
``test_torch_fsdpp.py`` holds the two-stage one), one window step (two
frames, the seed augmentation fed JAX's own uniform draws, the memory and
seeds carried across the frames) against the jitted JAX
``make_seq_train_step``, and a short twin run over ``SequenceLoader``
windows of synthetic frames. The three share one set of frames, incoming
state and weights.

The wrapped detector is single-stage FSD: the JAX step of two-stage FSD++
takes about 60 s to trace and compile here, this one about 13 s, and
what FSD++ adds to training (the merged cloud, the seed augmentation, the
window's mean, the carried state) is the same for both. Two-stage FSD's
loss and gradients are held at the same bar by
``test_torch_fsd_two_stage.py``; two-stage FSD++ trains through the CLI in
``test_torch_fsdpp.py``.

The JAX step runs with an optimizer that hands back the gradients as its
state (the step's update is then zero), so that one compiled step gives
the losses, every gradient and the carried state; the twin applies the JAX
package's AdamW to those gradients, as ``make_seq_train_step`` does inside.

Bars: losses 2e-5 relative; per-parameter gradients atol 1e-4 times
max(1, the tensor's largest |gradient|) (``test_torch_fsd_loss.py``); the
carried state's discrete parts exactly, its floats within 2e-5; the twin's
losses within the repository's 6e-3 relative, at base_lr 1e-6
(``test_torch_fsd_twin.py::TWIN_LR``).

A file of at most four tests (pytest-xdist's ``--dist loadfile``;
``test_torch_fsd.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from objectcentricocccompletion_tpu.data import frame_dataset as jfd
from objectcentricocccompletion_tpu.models.fsd import tiny_fsd_config
from objectcentricocccompletion_tpu.models import fsdpp as jpp
from objectcentricocccompletion_tpu.training import seq_trainer as jst
from objectcentricocccompletion_tpu.training.optim import (
    make_optimizer as jax_make_optimizer)
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.data import frame_dataset as tfd
from objectcentricocccompletion_torch.ops import seeds as tseeds
from objectcentricocccompletion_torch.training import seq_trainer as tst
from objectcentricocccompletion_torch.training.optim import make_optimizer
from tests.test_torch_fsd_loss import GRAD_ATOL, LOSS_RTOL
from tests.test_torch_fsd_twin import TWIN_LR
from tests.test_torch_fsdpp import (assert_state_equal, check_counts,
                                    check_sequence, incoming_state,
                                    init_params, jax_forward,
                                    sequence_frames, torch_fsdpp,
                                    torch_state)

from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

# one class, a one-level UNet and one SIR block: the JAX window step
# unrolls the grouping and the loss per class and per frame, and traces and
# compiles in about 13 s here so, against 31 s at the tiny config's three
# classes and three levels (the two-stage file holds every class; the FSD
# tests the UNet's and the SIR's depth)
TINY1 = dataclasses.replace(
    jpp.tiny_fsdpp_config(two_stage=False), fsd=dataclasses.replace(
        tiny_fsd_config(1), unet_channels=(16,), sir_blocks=1))

WINDOW = 2
TWIN_STEPS = 2
# four frames of one segment: sequential windows (0, 1) and (2, 3)
FRAMES = dict(num_frames=4, num_points=3000, num_boxes=8, xy_range=8.0,
              classes=("Car",))


def capture_grads():
    """An optax transformation whose state is the last gradients and whose
    update is zero. Its state starts as numpy zeros: eager JAX compiles one
    small program per op and shape, seconds over the params tree."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(np.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def jax_noise(rng, capacity):
    """The uniforms that the JAX step draws for each frame of the window
    from ``rng`` (``make_seq_train_step``'s keys)."""
    out = []
    for w in range(WINDOW):
        r_drop, r_fp = jax.random.split(jax.random.fold_in(rng, w))
        r_copy, r_shift = jax.random.split(r_fp)
        out.append(tseeds.SeedNoise(*(torch.tensor(np.asarray(u)) for u in (
            jax.random.uniform(r_drop, (capacity,)),
            jax.random.uniform(r_copy, (capacity,)),
            jax.random.uniform(r_shift, (capacity, 2))))))
    return out


def port_step(model, lr, steps, grad_clip=10.0):
    opt, schedule = make_optimizer(model.named_parameters(), lr, steps)
    return tst.make_seq_train_step(model, opt, schedule, WINDOW,
                                   grad_clip=grad_clip), schedule


@pytest.fixture(scope="module")
def reference():
    """The sequence's frames, the incoming state, the params and the
    compiled JAX training step."""
    frames = sequence_frames(TINY1, seed=31)
    state = incoming_state(TINY1, frames[0], seed=32)
    params = init_params(TINY1, seed=33)
    step = jst.make_seq_train_step(jpp.FSDPP(TINY1), capture_grads(),
                                   WINDOW)
    return frames, state, params, step


def test_single_stage_sequence_equals_the_jax_package(reference):
    frames, state, params, _ = reference
    states, crops = check_sequence(TINY1, jax_forward(TINY1), params,
                                   frames, state)
    check_counts(TINY1, frames, states, crops)


def test_window_step_losses_gradients_and_state(reference):
    """The mean losses, every parameter's gradient and the state handed
    to the next window."""
    frames, state, params, jstep = reference
    window = jst.SeqWindow(*(np.stack(a) for a in zip(*frames[:WINDOW])))
    rng = jax.random.PRNGKey(5)
    _, grads, new, aux = jax.tree_util.tree_map(np.asarray, jstep(
        params, capture_grads().init(params), window, state, rng))
    model = torch_fsdpp(params, TINY1)
    # no clip: the gradients are compared as the JAX step takes them
    step_fn, _ = port_step(model, 1e-5, 10, grad_clip=float("inf"))
    batch = tst.SeqWindow(*(torch.tensor(a) for a in window[:5]))
    got_state, got = step_fn(0, batch, torch_state(state),
                             noise=jax_noise(rng, TINY1.max_seeds))
    assert set(got) == set(aux)
    for k, ref in aux.items():
        ref = float(ref)
        assert abs(float(got[k]) - ref) <= LOSS_RTOL * max(abs(ref), 1e-3), \
            (k, float(got[k]), ref)
    assert float(aux["num_pos_clusters"]) > 0 and float(aux["loss_size"]) > 0
    assert_state_equal(got_state, new, "carried state")

    tree = convert.state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})
    flat_ref = jax.tree_util.tree_flatten_with_path(grads)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat_ref) == len(flat_got)
    worst = sorted(((float(np.abs(flat_got[p] - g).max())
                     / (GRAD_ATOL * max(1.0, float(np.abs(g).max()))),
                     jax.tree_util.keystr(p)) for p, g in flat_ref),
                   reverse=True)[:3]
    print(f"window step gradients: worst share of the bar {worst}")
    assert worst[0][0] <= 1.0, worst
    assert max(float(np.abs(g).max()) for _, g in flat_ref) > 1.0


def test_twin_training_over_sequence_windows(reference, tmp_path):
    """``TWIN_STEPS`` steps from one converted init on the same windows of
    ``SequenceLoader(sequential=True)``: the memory carried within a
    segment and fresh at its start, the seed noise of the JAX keys."""
    _, _, params, jstep = reference
    root = str(tmp_path)
    info = tfd.write_synthetic_frames(root, seed=7, **FRAMES)
    kw = dict(max_points=TINY1.fsd.max_points, max_gt=8)
    jloader = jst.SequenceLoader(jfd.FrameDataset(info, root, **kw), WINDOW,
                                 sequential=True)
    tloader = tst.SequenceLoader(tfd.FrameDataset(info, root, **kw), WINDOW,
                                 sequential=True)
    tx, _ = jax_make_optimizer(TWIN_LR, TWIN_STEPS)
    opt_state = jax.jit(tx.init)(params)

    @jax.jit
    def apply_tx(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    model = torch_fsdpp(params, TINY1)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    step_fn, schedule = port_step(model, TWIN_LR, TWIN_STEPS)
    mem0 = jpp.init_sequence_state(TINY1, 5)
    jmem, tmem = mem0, model.init_state(5)
    base = jax.random.PRNGKey(1)
    jl, tl, carries = [], [], []
    for step in range(TWIN_STEPS):
        jb, tb = next(jloader), next(tloader)
        for a, b in zip(tb, jb):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        carries.append(jloader.carry)
        if not jloader.carry:
            jmem, tmem = mem0, model.init_state(5)
        rng = jax.random.fold_in(base, step)
        _, grads, jmem, aux = jstep(params, capture_grads().init(params),
                                    jb, jmem, rng)
        params, opt_state = apply_tx(grads, opt_state, params)
        params = jax.tree_util.tree_map(np.asarray, params)
        tmem, got = step_fn(step, tb, tmem,
                            noise=jax_noise(rng, TINY1.max_seeds))
        jl.append(float(aux["loss"]))
        tl.append(float(got["loss"]))
    assert carries == [False, True]
    jl, tl = np.asarray(jl), np.asarray(tl)
    rel = np.abs(tl - jl) / np.abs(jl)
    print(f"twin losses jax {jl} port {tl} max rel dev {rel.max():.2e}")
    assert rel.max() <= 6e-3, rel
    final = convert.state_dict_to_flax(
        {n: p for n, p in model.named_parameters()})
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(final)[0])
    worst = max(float(np.abs(flat_got[p] - r).max()) for p, r in flat_ref)
    lr_sum = sum(schedule(s) for s in range(TWIN_STEPS))
    moved = max(float((p.detach() - init[n]).abs().max())
                for n, p in model.named_parameters())
    print(f"twin final params max abs diff {worst:.2e}, largest move "
          f"{moved:.2e} (lr sum {lr_sum:.2e})")
    assert moved > 0.5 * lr_sum
    assert worst <= 2 * lr_sum
    assert_state_equal(tmem, jmem, "twin final state")
