"""CTRL's TrackletSegmentor and OcOccNet's ``use_segmentor`` in the port,
held against the JAX package on the CPU.

Inputs come from a numpy seed; weights cross over through ``convert.py``.
Bars: the segmentor's float32 features within 2e-5 absolute (masked rows
exactly 0); the model's float32 outputs and losses at the OcOccNet bar
(2e-4, ``test_torch_ococcnet.py``); every gradient within 1e-4.

A file of at most four tests (pytest-xdist's ``--dist loadfile`` hands out
the files with the most tests first)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_tpu.models import tracklet_segmentor as jseg
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import ococcnet as tnet
from objectcentricocccompletion_torch.models import tracklet_segmentor as tseg
from tests.test_torch_ococc_train import NO_DROPOUT, _compare_losses
from tests.test_torch_ococcnet import (FP32_TOL, OUT_KEYS, TINY, _batch,
                                       _compare, _jax_forward, _jbatch,
                                       _param_shapes, _port_forward,
                                       _port_model, _random_params,
                                       _torch_config)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

SEG_TOL = 2e-5
GRAD_TOL = 1e-4
# dense CTRL, and OcOccNet packed over budget (8 frames of 16-64 points into
# 128 slots), each with the tiny segmentor; dropout 0 for the gradients
CONFIGS = {
    "ctrl": dataclasses.replace(TINY, variant="ctrl", use_segmentor="tiny",
                                corner_loss_weight=1.0, **NO_DROPOUT),
    "packed": dataclasses.replace(TINY, use_segmentor="tiny",
                                  packed_point_budget=128, packed_quantum=16,
                                  **NO_DROPOUT),
}


@functools.lru_cache(maxsize=None)
def _params(name):
    cfg = CONFIGS[name]
    shapes = _param_shapes(cfg, _jbatch(_batch(cfg)))
    return jax.tree_util.tree_map(np.asarray, _random_params(shapes, 11))


def _cloud(n=384, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-20, 20, (n, 10)).astype(np.float32)
    pts[: n // 4, :3] = rng.uniform(-1.5, 1.5, (n // 4, 3))  # shared voxels
    return pts, rng.randint(0, 32, (n,)).astype(np.int32), rng.rand(n) < 0.7


def test_segmentor_matches_the_jax_package():
    """The tiny segmentor on 384 points (a quarter packed into a few
    voxels, 30% masked): features within 2e-5, masked rows exactly 0."""
    cfg = jseg.tiny_segmentor_config()
    jmodel = jseg.TrackletSegmentor(cfg)
    pts, finds, mask = _cloud()
    args = (jnp.asarray(pts), jnp.asarray(finds), jnp.asarray(mask))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *args)["params"]
    ref = np.asarray(jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))(
        params, *args))
    model = tseg.TrackletSegmentor(tseg.tiny_segmentor_config(), 10)
    model.load_state_dict(convert.flax_to_state_dict(
        jax.device_get(params)))
    with torch.no_grad():
        got = model(torch.from_numpy(pts), torch.from_numpy(finds),
                    torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape == (384, model.out_channels)
    assert not got[~mask].any()
    assert np.abs(ref[mask]).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=SEG_TOL, rtol=0)
    assert model.voxel_count(torch.from_numpy(pts[:, :3]),
                             torch.from_numpy(mask)) > 64


def test_predict_with_the_segmentor_matches():
    """predict (and the occupancy decode) of CTRL in the dense layout and
    of OcOccNet in the packed one, each with the tiny segmentor."""
    for name, cfg in CONFIGS.items():
        params = _params(name)
        b = _batch(cfg)
        ref = _jax_forward(cfg)(params, _jbatch(b))
        got = _port_forward(_port_model(cfg, params), b)
        _compare(got, ref, FP32_TOL, OUT_KEYS)


def test_losses_and_every_gradient_match():
    """The loss dict and every gradient, the segmentor's among them, of the
    packed OcOccNet with the tiny segmentor."""
    cfg = CONFIGS["packed"]
    params = _params("packed")
    b = _batch(cfg)
    jmodel = jnet.OcOccNetWithLoss(cfg)
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, x: jmodel.apply({"params": p}, x, train=True),
        has_aux=True))(params, _jbatch(b))
    model = _port_model(cfg, params)
    model.train()
    total, got = model(b)
    total.backward()
    _compare_losses(got, ref, FP32_TOL)
    grads = convert.flax_to_state_dict(jax.device_get(ref_grads))
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    seg = [k for k in grads if k.startswith("net.segmentor.")]
    assert any(k.endswith("unet.down1") for k in seg)
    assert sum(float(grads[k].abs().max()) > 1e-4 for k in seg) > \
        len(seg) // 2
    for k, g in grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   atol=GRAD_TOL, rtol=0, err_msg=k)


def test_converter_round_trip_of_the_segmentor_subtree():
    """flax -> state_dict -> flax gives the tree back, the UNet's bare
    ``down{i}`` and sparse ``kernel``s untransposed, Dense kernels
    transposed; the port's model takes the state_dict whole, and its own
    seeded init draws every sparse kernel (he_normal)."""
    params = _params("ctrl")
    sd = convert.flax_to_state_dict(params)
    back = convert.state_dict_to_flax(sd)
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(flat_back[k], v)
    seg = params["net"]["segmentor"]
    assert seg["unet"]["down1"].ndim == 3
    np.testing.assert_array_equal(sd["net.segmentor.unet.down1"].numpy(),
                                  seg["unet"]["down1"])
    np.testing.assert_array_equal(
        sd["net.segmentor.vfe.vfe_0.weight"].numpy(),
        seg["vfe"]["vfe_0"]["kernel"].T)
    model = _port_model(CONFIGS["ctrl"], params)
    assert set(model.state_dict()) >= set(sd)
    drawn = tnet.OcOccNetWithLoss(_torch_config(CONFIGS["ctrl"]), "cpu",
                                  torch.Generator().manual_seed(0))
    down = drawn.state_dict()["net.segmentor.unet.down1"]
    std = (2.0 / (down.shape[0] * down.shape[1])) ** 0.5
    assert 0.5 * std < float(down.std()) < 1.5 * std
