"""The port's SST training pieces held against the JAX package on the CPU:
the tiny detector's loss dict and every parameter's gradient, the
learning-rate schedule, the weight-decay split, the frozen parameters, the
global-norm clip, and the entry points' refusal of a missing card.

Weights come from one JAX parameter tree (shapes from ``jax.eval_shape``,
values from numpy) through ``convert.flax_to_state_dict``; the port's
gradients go back through ``convert.state_dict_to_flax``. The loss, the
gradients and the no-decay split are in ``test_torch_sst_grads.py``.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from objectcentricocccompletion_tpu.models import sst_detector as jdet
from objectcentricocccompletion_tpu.training import optim as joptim
from objectcentricocccompletion_torch.models import sst_detector as tdet
from objectcentricocccompletion_torch.tools import train as ttrain
from objectcentricocccompletion_torch.training import optim as toptim
from objectcentricocccompletion_torch.training.detector_trainer import (
    train_detector)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TINY = jdet.tiny_sst_detector_config()


# use_kernel: the attention through the autograd Function (the plain
# backward on the CPU), or the einsum differentiated by autograd
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
