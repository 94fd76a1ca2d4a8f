"""The flat and stacked optimizer layouts of the port (``parallel/train.py``:
the specs and their helpers, ``create_train_state(flat_opt= | stacked_opt=)``,
``make_train_step(flat_opt=, stacked_spec=)``; ``training/optim.py``:
``make_flat_optimizer``, ``make_stacked_optimizer``, ``BufferAdamW``) held
against the JAX package's on the CPU at ``tiny_config()``, on one
converted parameter tree.

Bars: the specs equal (entries, offsets, sizes, stack keys) and the round
trips exact; parameters and moments after 3 updates within 1e-6 of optax's
chains on the same seeded gradients (the port's AdamW takes torch's order
of operations and float64 bias corrections: about 2e-5 of a step, at most
2e-7 at these rates, beside float32's rounding of O(1) weights); the
losses and ``grad_norm`` of 3 steps within 1e-6 of the tree step's,
relative to the larger of 1 and their size.

A file of at most four tests (pytest-xdist's ``--dist loadfile``; see
``test_torch_centerpoint.py``); every JAX reference is one jitted
function."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from objectcentricocccompletion_tpu.parallel import train as jtrain
from objectcentricocccompletion_tpu.training import optim as joptim
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.configs.ococcnet_config import (
    tiny_config)
from objectcentricocccompletion_torch.data.synthetic import synthetic_batch
from objectcentricocccompletion_torch.models.ococcnet import OcOccNetWithLoss
from objectcentricocccompletion_torch.parallel import train as ttrain
from objectcentricocccompletion_torch.training import optim as toptim
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

CFG = tiny_config()
BAR = 1e-6


@pytest.fixture(scope="module")
def tree():
    """The port's tiny OcOccNet parameters (name -> tensor) and the same as
    the JAX package's flax tree."""
    named = {n: p.detach() for n, p in OcOccNetWithLoss(
        CFG, "cpu", torch.Generator().manual_seed(0)).named_parameters()}
    return named, convert.state_dict_to_flax(named)


def test_specs_equal_the_jax_package(tree):
    """Entries, offsets, sizes and stack keys in the flax tree's leaf
    order; the flat vectors and the stacks element for element; the round
    trips exact, the unflattened tensors views."""
    named, params = tree
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    jflat = jtrain.make_flat_opt_spec(params)
    jstack = jtrain.make_stacked_opt_spec(params)
    ref = jax.jit(lambda p: (jtrain.flatten_by_spec(jflat, p),
                             jtrain.stack_by_spec(jstack, p)))(params)
    flat = ttrain.make_flat_opt_spec(named)
    stack = ttrain.make_stacked_opt_spec(named)
    for spec in (flat, stack):
        assert [jax.tree_util.keystr(tuple(
            jax.tree_util.DictKey(k) for k in convert.flax_leaf(
                n, named[n].shape)[0])) for n in spec.names] == paths
    assert [e[:4] for e in flat.entries] == [
        (g, o, s, tuple(sh)) for g, o, s, sh, _ in jflat.entries]
    assert flat.sizes == jflat.sizes and flat.sizes["nodecay"] > 0
    assert all(str(e[4]) == f"torch.{jnp.dtype(j[4])}"
               for e, j in zip(flat.entries, jflat.entries))
    assert [e[:3] for e in stack.entries] == [
        (k, s, tuple(sh)) for k, s, sh, _ in jstack.entries]
    assert {k: v[:2] for k, v in stack.groups.items()} == {
        k: (c, tuple(sh)) for k, (c, sh, _) in jstack.groups.items()}
    assert any(k.startswith("d:float32:") for k in stack.groups)
    got = ttrain.flatten_by_spec(flat, named)
    stacked = ttrain.stack_by_spec(stack, named)
    for a, b in ((got, ref[0]), (stacked, ref[1])):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    for back, store in ((ttrain.unflatten_by_spec(flat, got), got),
                        (ttrain.unstack_by_spec(stack, stacked), stacked)):
        assert set(back) == set(named)
        for n, t in named.items():
            assert torch.equal(back[n], t), n
            base = back[n].untyped_storage().data_ptr()
            assert any(base == s.untyped_storage().data_ptr()
                       for s in store.values()), n


def _jax_updates(layout, params, runs, lr_args):
    """optax's flat or stacked chain over 3 updates from ``params`` with
    each run's gradients ``run[i]`` (one jitted update, called per step):
    per run the parameters and (mu, nu) after each update."""
    make = (joptim.make_flat_optimizer if layout == "flat"
            else joptim.make_stacked_optimizer)
    tx, _ = make(*lr_args)

    @jax.jit
    def update(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    out = []
    for gs in runs:
        p, state, steps = params, jax.jit(tx.init)(params), []
        for g in gs:
            p, state = update(g, state, p)
            adam = state[1][0]
            steps.append((p, adam.mu, adam.nu))
        out.append(steps)
    return out


@pytest.mark.parametrize("layout", ["flat", "stacked"])
def test_updates_equal_the_optax_chain(tree, layout):
    """3 updates of ``make_flat_optimizer`` / ``make_stacked_optimizer`` on
    seeded gradients against optax's chain (clip by global norm 10, AdamW
    with the decay mask of the group), with the clip inactive (norm about
    1) and active (about 1000)."""
    named, _ = tree
    if layout == "flat":
        buffers = ttrain.flatten_by_spec(ttrain.make_flat_opt_spec(named),
                                         named)
        make = toptim.make_flat_optimizer
    else:
        buffers = ttrain.stack_by_spec(ttrain.make_stacked_opt_spec(named),
                                       named)
        make = toptim.make_stacked_optimizer
    lr_args = (1e-4, 20)          # lr 1e-4 -> 1e-2 over the first 2 steps
    rng = np.random.RandomState(0)
    norm = np.sqrt(sum(v.numel() for v in buffers.values()))
    scales = (1.0, 1000.0)
    runs = [[{k: (rng.randn(*v.shape) * scale / norm).astype(np.float32)
              for k, v in buffers.items()} for _ in range(3)]
            for scale in scales]
    refs = _jax_updates(layout, {k: v.numpy() for k, v in buffers.items()},
                        runs, lr_args)
    for scale, grads, ref in zip(scales, runs, refs):
        opt, schedule = make({k: v.clone() for k, v in buffers.items()},
                             *lr_args)
        for i, g in enumerate(grads):
            for k in g:
                opt.grads[k].copy_(torch.from_numpy(g[k]))
            gnorm = float(opt.step(schedule(i)))
            assert abs(gnorm - scale) <= 0.01 * scale
            for got, want in ((opt.params, ref[i][0]), (opt.exp_avg,
                                                        ref[i][1]),
                              (opt.exp_avg_sq, ref[i][2])):
                for k in got:
                    np.testing.assert_allclose(got[k].numpy(),
                                               np.asarray(want[k]), rtol=0,
                                               atol=BAR, err_msg=k)
        moved = max(float((opt.params[k] - buffers[k]).abs().max())
                    for k in buffers)
        assert moved > 1e-3


def test_train_steps_equal_the_tree_step_and_refusals():
    """``make_train_step`` with the flat and the stacked layout against the
    tree step, 3 steps from the same weights: the loss dict and
    ``grad_norm``; the parameters stay whole tensors under the tree's names,
    views of the buffers, and so do their gradients. Then what they refuse,
    as the JAX package: ``fixed_ae``, a TP or FSDP layout, an optimizer of
    the other kind."""
    batch = synthetic_batch(CFG, batch_size=2, seed=0)
    runs = {}
    for layout in ("tree", "flat", "stacked"):
        state = ttrain.create_train_state(CFG, 10, "cpu", 0,
                                          flat_opt=layout == "flat",
                                          stacked_opt=layout == "stacked")
        model, opt, schedule = state[:3]
        step = ttrain.make_train_step(
            model, opt, schedule, seed=1, flat_opt=layout == "flat",
            stacked_spec=state[3] if layout == "stacked" else None)
        runs[layout] = [{k: float(v) for k, v in step(i, batch).items()}
                        for i in range(3)]
        if layout != "tree":
            ptrs = {b.untyped_storage().data_ptr() for b in
                    list(opt.params.values()) + list(opt.grads.values())}
            for n, p in model.named_parameters():
                assert p.untyped_storage().data_ptr() in ptrs, n
                assert p.grad.untyped_storage().data_ptr() in ptrs, n
            sd = model.state_dict()
            assert {n: tuple(t.shape) for n, t in sd.items()} == {
                n: tuple(t.shape) for n, t in tree_sd.items()}
        else:
            tree_sd = model.state_dict()
    for layout in ("flat", "stacked"):
        for got, want in zip(runs[layout], runs["tree"]):
            assert set(got) == set(want)
            for k in want:
                assert abs(got[k] - want[k]) <= BAR * max(1.0, abs(want[k])), \
                    (layout, k, got[k], want[k])
    assert runs["tree"][0]["grad_norm"] > CFG.grad_clip_norm

    with pytest.raises(ValueError, match="fixed_ae"):
        ttrain.create_train_state(dataclasses.replace(CFG, fixed_ae=True), 10,
                                  "cpu", flat_opt=True)
    with pytest.raises(ValueError, match="fixed_ae"):
        ttrain.create_train_state(dataclasses.replace(CFG, fixed_ae=True), 10,
                                  "cpu", stacked_opt=True)
    model, opt, schedule = ttrain.create_train_state(CFG, 10, "cpu",
                                                     flat_opt=True)
    tp_mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    for kw in (dict(mesh=tp_mesh), dict(fsdp=True)):
        with pytest.raises(ValueError, match="TP and FSDP"):
            ttrain.make_train_step(model, opt, schedule, flat_opt=True, **kw)
    with pytest.raises(ValueError, match="flat_opt=True"):
        ttrain.make_train_step(model, opt, schedule)
    tree_model, tree_opt, _ = ttrain.create_train_state(CFG, 10, "cpu")
    with pytest.raises(ValueError, match="create_train_state"):
        ttrain.make_train_step(tree_model, tree_opt, schedule, flat_opt=True)
