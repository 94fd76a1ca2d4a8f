"""OcOccNet's bf16 dtype flow and the converter's round trip of the full
parameter tree, and CTRL's predict, held against the JAX package
(moved out of ``test_torch_ococcnet.py``, whose helpers and bars they
use).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.configs import ococcnet_config as jcfgm
from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import ococcnet as tnet
from tests.test_torch_ococcnet import (BF16_TOL, CONFIGS, _batch, _compare,
                                       _jax_forward, _jbatch, _param_shapes,
                                       _params, _port_forward, _port_model,
                                       _torch_config, check_predict_and_decode)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def test_bf16_dtype_flow_matches():
    """bfloat16 compute, packed layout: the same casts as the JAX package
    (float32 parameters, norm statistics, softmax and head outputs)."""
    cfg = dataclasses.replace(CONFIGS["packed"], compute_dtype="bfloat16")
    params = _params("ococc")
    b = _batch(cfg)
    ref = _jax_forward(cfg)(params, _jbatch(b))
    got = _port_forward(_port_model(cfg, params), b)
    assert got[0]["ae_latent"].dtype == torch.bfloat16
    assert np.asarray(ref[0]["ae_latent"]).dtype == jnp.bfloat16
    for k in ("cls_logit", "bbox_pred", "shape_latent", "boxes"):
        assert got[0][k].dtype == torch.float32, k
    # the O(1) outputs (the boxes are their float32 decode, in metres)
    _compare(got, ref, BF16_TOL, ("scores", "cls_logit", "bbox_pred",
                                  "shape_latent", "ae_latent", "nonempty"))


def test_convert_round_trip_full_config():
    """The whole ``OcOccNetConfig()`` tree (shapes from ``jax.eval_shape``
    on a short tracklet, nothing runs; traced in the dense layout, whose
    tree is the packed one's): every flax leaf lands in the port's module
    shape for shape and comes back unchanged."""
    cfg = jcfgm.OcOccNetConfig()
    B, L, P, K = 1, 4, 16, 8
    f32 = jnp.float32
    S = jax.ShapeDtypeStruct
    batch = jnet.TrackletBatch(
        S((B, L, P, cfg.points_dim), f32), S((B, L, P), jnp.bool_),
        S((B, L, 7), f32), S((B, L), f32), S((B, L), jnp.int32),
        S((B, L, 7), f32), S((B, L), jnp.bool_), S((B, K, 3), f32),
        S((B, K), jnp.int32), S((B, K), jnp.bool_), S((B,), f32))
    shapes = _param_shapes(dataclasses.replace(
        cfg, packed_point_budget=None, roi_point_budget=None), batch)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.random(s.shape, np.float32), shapes)
    sd = convert.flax_to_state_dict(params)
    tmodel = tnet.OcOccNetWithLoss(_torch_config(cfg), device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    back = convert.state_dict_to_flax(tmodel.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert flat_b[path].shape == leaf.shape, path
        assert np.array_equal(flat_b[path], leaf), path


@pytest.mark.parametrize("name", ["ctrl"])
def test_predict_and_decode_match(name):
    check_predict_and_decode(name)
