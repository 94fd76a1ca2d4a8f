"""OcOccNet losses, gradients and one AdamW step held against the JAX
package (moved out of ``test_torch_ococc_train.py``, whose helpers
and bars they use).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import dataclasses
import functools

import jax
import numpy as np
import optax
import pytest

from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_tpu.training import optim as joptim
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.parallel import train as ttrain
from tests.test_torch_ococc_train import (CONFIGS, FP32_TOL, _compare_losses,
                                          _port_model, _variant)
from tests.test_torch_ococcnet import _batch, _jbatch, _params, _torch_config
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

GRAD_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name):
    """The JAX loss and its gradient, jitted once per layout."""
    model = jnet.OcOccNetWithLoss(CONFIGS[name])

    def loss(p, b):
        return model.apply({"params": p}, b, train=True)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_losses_and_gradients_match(name):
    """The loss dict in float32 and every parameter's gradient, dropout 0
    (the ctrl variant with its corner loss on)."""
    cfg = CONFIGS[name]
    params = _params(_variant(cfg))
    b = _batch(cfg)
    (_, ref), ref_grads = _jax_value_and_grad(name)(params, _jbatch(b))
    model = _port_model(cfg, params)
    total, got = model(b)
    total.backward()
    _compare_losses(got, ref, FP32_TOL)
    if cfg.variant == "ctrl":
        assert float(got["loss_rcnn_corner"]) > 0
        assert "loss_rcnn_occ" not in got
    else:
        assert float(got["loss_rcnn_occ"]) > 0
    grads = convert.flax_to_state_dict(jax.device_get(ref_grads))
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for k, g in grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   atol=GRAD_TOL, rtol=0, err_msg=k)
    assert sum(float(g.abs().max()) > 1e-3 for g in grads.values()) > \
        len(grads) // 2


def test_train_step_matches_the_jax_step():
    """One step of the JAX package's single-device step (the body of
    ``make_train_step`` with the tree optimizer: the loss's value and
    gradient, ``optax.global_norm`` of the gradients, ``tx.update`` and
    ``apply_updates``; ``make_train_step`` itself runs in the twin test)
    and of the port's, from the same weights and batch (dropout 0, the
    packed layout, lr 1e-3 so that the update shows): the loss dict,
    grad_norm (before the clip) and every parameter after the update.
    Adam's first step moves a parameter by lr in the sign of its gradient,
    so where a gradient lies within the gradient bar of 0 the two may move
    it 2 lr apart."""
    cfg = dataclasses.replace(CONFIGS["packed"], base_lr=1e-3)
    params = _params("ococc")
    b = _batch(cfg)
    tx, _ = joptim.make_optimizer(cfg.base_lr, 10,
                                  weight_decay=cfg.weight_decay,
                                  grad_clip=cfg.grad_clip_norm,
                                  peak_ratio=cfg.lr_mult)
    (_, ref), grads = _jax_value_and_grad("packed")(params, _jbatch(b))

    @jax.jit
    def update(grads, params):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates), optax.global_norm(grads)

    new_params, grad_norm = update(grads, params)
    new_params = convert.flax_to_state_dict(jax.device_get(new_params))
    ref = dict(jax.device_get(ref), grad_norm=grad_norm)

    tmodel, opt, schedule = ttrain.create_train_state(
        _torch_config(cfg), 10, "cpu")
    tmodel.load_state_dict(convert.flax_to_state_dict(params))
    got = ttrain.make_train_step(tmodel, opt, schedule)(0, b)
    _compare_losses({k: v for k, v in got.items() if k != "grad_norm"},
                    {k: v for k, v in ref.items() if k != "grad_norm"},
                    FP32_TOL)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(ref["grad_norm"]), rtol=1e-4)
    assert float(ref["grad_norm"]) > cfg.grad_clip_norm   # the clip bites
    lr = cfg.base_lr
    for n, p in tmodel.named_parameters():
        g = p.grad.numpy()          # the clipped gradient
        tol = 1e-6 + np.where(np.abs(g) < GRAD_TOL, 2 * lr, 1e-3 * lr)
        diff = np.abs(p.detach().numpy() - new_params[n].numpy())
        assert (diff <= tol).all(), (n, diff.max())
    before = convert.flax_to_state_dict(params)
    assert max(float((new_params[n] - before[n]).abs().max())
               for n in new_params) > 0.5 * lr
