"""The port's SST training pieces held against the JAX package on the CPU:
the tiny detector's loss dict and every parameter's gradient, the
learning-rate schedule, the weight-decay split, the frozen parameters, the
global-norm clip, and the entry points' refusal of a missing card.

Weights come from one JAX parameter tree (shapes from ``jax.eval_shape``,
values from numpy) through ``convert.flax_to_state_dict``; the port's
gradients go back through ``convert.state_dict_to_flax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from objectcentricocccompletion_tpu.models import sst_detector as jdet
from objectcentricocccompletion_tpu.training import optim as joptim
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import sst_detector as tdet
from objectcentricocccompletion_torch.tools import train as ttrain
from objectcentricocccompletion_torch.training import optim as toptim
from objectcentricocccompletion_torch.training.detector_trainer import (
    train_detector)
from tests.test_torch_sst import _frame, _random_params, _torch_config
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TINY = jdet.tiny_sst_detector_config()


def _gt(cfg, num_valid=5, seed=3):
    """The first ``num_valid`` boxes of the frame's ``synth_frame``, padded
    to ``max_gt`` with invalid zeros."""
    from objectcentricocccompletion_torch.data.synthetic import synth_frame
    _, _, boxes, labels, _ = synth_frame(cfg.sst.max_points,
                                         cfg.sst.pc_range, num_real=1800,
                                         seed=seed)
    gb = np.zeros((cfg.max_gt, 7), np.float32)
    gl = np.zeros((cfg.max_gt,), np.int32)
    gb[:num_valid], gl[:num_valid] = boxes[:num_valid], labels[:num_valid]
    return gb, gl, np.arange(cfg.max_gt) < num_valid


@pytest.fixture(scope="module")
def tiny_grads():
    """The JAX loss dict and gradients of the tiny detector on one frame,
    with the numpy params and inputs they came from."""
    points, mask = _frame(TINY, 1800, seed=3)
    gb, gl, gv = _gt(TINY)
    model = jdet.SSTDetector(TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), points, mask)
    params = jax.tree_util.tree_map(np.asarray,
                                    _random_params(shapes["params"], 6))

    def loss_fn(p):
        out = model.apply({"params": p}, points, mask,
                          *map(jnp.asarray, (gb, gl, gv)),
                          method=model.loss)
        return out["loss"], out

    (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return dict(inputs=(points, mask, gb, gl, gv), params=params,
                aux={k: np.asarray(v) for k, v in aux.items()},
                grads=jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_and_grads(tiny_grads, use_kernel):
    cfg = _torch_config(TINY)
    cfg = dataclasses.replace(cfg, sst=dataclasses.replace(
        cfg.sst, use_pallas_attention=use_kernel))
    model = tdet.SSTDetector(cfg, device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(tiny_grads["params"]))
    out = model.loss(*map(torch.from_numpy, tiny_grads["inputs"]))
    out["loss"].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    return out, convert.state_dict_to_flax(grads)


# use_kernel: the attention through the autograd Function (the plain
# backward on the CPU), or the einsum differentiated by autograd
@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["function", "einsum"])
def test_tiny_detector_loss_and_gradients(tiny_grads, use_kernel):
    out, grads = _port_loss_and_grads(tiny_grads, use_kernel)
    ref = tiny_grads["aux"]
    assert set(out) == set(ref)
    assert int(out["num_pos_anchors"]) == int(ref["num_pos_anchors"]) > 0
    for k in ("loss_cls", "loss_bbox", "loss_dir", "loss"):
        # float32, 12 attention layers and the neck: rtol 1e-5
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    flat_ref = jax.tree_util.tree_flatten_with_path(tiny_grads["grads"])[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert len(flat_ref) == len(flat_got)
    for path, r in flat_ref:
        # the repository's per-parameter gradient bar: atol 1e-4
        np.testing.assert_allclose(flat_got[path], r, atol=1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_cyclic_cosine_schedule_matches():
    for base, total in ((1e-5, 50), (2e-4, 7), (1e-3, 1)):
        j = joptim.cyclic_cosine_schedule(base, total)
        t = toptim.cyclic_cosine_schedule(base, total)
        peak = 100 * base
        for step in range(total + 3):
            # JAX evaluates in float32, where peak + (lo - hi) * ... cancels
            # near the ends: rtol 1e-6 and float32's eps times the peak
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6,
                                       atol=1.2e-7 * peak,
                                       err_msg=f"{base} {total} {step}")


def test_no_decay_split_matches_the_jax_mask(tiny_grads):
    params = tiny_grads["params"]
    mask = joptim._no_decay_mask(params)
    as_arrays = jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, float(m), np.float32), mask, params)
    ref = {n for n, t in convert.flax_to_state_dict(as_arrays).items()
           if t.flatten()[0] == 1.0}
    model = tdet.SSTDetector(_torch_config(TINY), device="cpu")
    got = {n for n, _ in model.named_parameters() if toptim.decays(n)}
    assert got == ref
    assert got and all(n.endswith("weight") for n in got)
    opt, _ = toptim.make_optimizer(model.named_parameters(), 1e-5, 10)
    decay, plain = opt.param_groups
    assert decay["weight_decay"] == 0.05 and plain["weight_decay"] == 0.0
    assert len(decay["params"]) == len(got)
    assert len(decay["params"]) + len(plain["params"]) == \
        len(list(model.parameters()))
    assert decay["betas"] == (0.9, 0.999) and decay["eps"] == 1e-8


def test_frozen_prefixes_get_no_update():
    model = tdet.SSTDetector(tdet.tiny_sst_detector_config(), "cpu",
                             torch.Generator().manual_seed(0))
    opt, schedule = toptim.make_optimizer(
        model.named_parameters(), 1e-3, 10,
        frozen_prefixes=("backbone.vfe",))
    in_groups = {id(p) for g in opt.param_groups for p in g["params"]}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith("backbone.vfe")}
    assert frozen and not any(id(p) in in_groups
                              for n, p in model.named_parameters()
                              if n in frozen)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    toptim.set_lr(opt, schedule(0))
    opt.step()
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), frozen[n]) if n in frozen \
            else None
        assert moved is None or not moved, n
    assert not torch.equal(model.head.cls.weight.detach(),
                           model.head.cls.weight.detach() + 1)
    assert all(len(opt.state[p]) for g in opt.param_groups
               for p in g["params"])


@pytest.mark.parametrize("scale", [0.01, 1.0, 100.0])
def test_clip_matches_optax(scale):
    rng = np.random.RandomState(1)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    grads = [(scale * rng.randn(*s)).astype(np.float32) for s in shapes]
    clipped, _ = optax.clip_by_global_norm(10.0).update(
        [jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = toptim.clip_grad_global_norm_(params, 10.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for p, r in zip(params, clipped):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0)


def test_training_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    model = tdet.SSTDetector(tdet.tiny_sst_detector_config(), "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        train_detector(model, None, str(tmp_path), total_steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["sst", "--infos", "x.pkl", "--data-root", "x",
                     "--total-steps", "1"])
