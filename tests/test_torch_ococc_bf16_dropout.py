"""OcOccNet bf16 losses and the dropout placements held against the JAX
package (moved out of ``test_torch_ococc_train.py``, whose helpers
and bars they use).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import dataclasses

import jax
import pytest
import torch

from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_torch.models import layers as tlayers
from tests.test_torch_ococc_train import (BF16_TOL, CONFIGS, FP32_TOL, TINY,
                                          _compare_losses, _port_model,
                                          _port_words, _spy_hash_bits,
                                          _variant)
from tests.test_torch_ococcnet import _batch, _jbatch, _params
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def test_dropout_placements_match(monkeypatch):
    """Every dropout site, in call order, with JAX's key words: the port
    draws at the same places on tensors of the same shapes, and the
    float32 loss dict with dropout on agrees."""
    calls = _spy_hash_bits(monkeypatch)
    cfg = dataclasses.replace(TINY, packed_point_budget=128,
                              packed_quantum=16)
    params = _params("ococc")
    b = _batch(cfg)
    model = jnet.OcOccNetWithLoss(cfg)

    def fwd(p, batch, rng):
        calls.clear()
        _, aux = model.apply({"params": p}, batch, train=True,
                             rngs={"dropout": rng})
        return aux, [w for w, _ in calls]

    ref, words = jax.jit(fwd)(params, _jbatch(b), jax.random.PRNGKey(11))
    jax_shapes = [s for _, s in calls]
    # 1 attention layer, latent, fusion, cls and reg hidden layers, the
    # decoder's first layer and its 2 hidden layers
    assert len(jax_shapes) == 8

    port_shapes = []
    orig = tlayers.hash_bits

    def spy(key, shape, offset=0):
        port_shapes.append(tuple(shape))
        return orig(key, shape, offset)

    monkeypatch.setattr(tlayers, "hash_bits", spy)
    keys = tlayers.DropoutKeys(words=_port_words(words))
    with torch.no_grad():
        _, got = _port_model(cfg, params)(b, keys=keys)
    assert keys.site == len(words)
    assert port_shapes == jax_shapes
    _compare_losses(got, ref, FP32_TOL)
    # and dropout moved the losses: the forward without it differs
    with torch.no_grad():
        _, plain = _port_model(cfg, params)(b, train=False)
    assert abs(float(plain["loss"]) - float(ref["loss"])) > 1e-3


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_losses_match(name):
    cfg = dataclasses.replace(CONFIGS[name], compute_dtype="bfloat16")
    params = _params(_variant(cfg))
    b = _batch(cfg)
    model = jnet.OcOccNetWithLoss(cfg)
    ref = jax.jit(lambda p, bb: model.apply({"params": p}, bb,
                                            train=True)[1])(params,
                                                            _jbatch(b))
    with torch.no_grad():
        _, got = _port_model(cfg, params)(b)
    for v in got.values():
        assert v.dtype == torch.float32
    _compare_losses(got, ref, BF16_TOL)
