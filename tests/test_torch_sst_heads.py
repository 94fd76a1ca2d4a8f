"""SST's anchor-head decode and the converter's round trip held against
the JAX package (moved out of ``test_torch_sst.py``, whose helpers
and bars they use).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from objectcentricocccompletion_tpu.models import (anchor_head as jah,
                                                   sst_detector as jdet)
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import (anchor_head as tah,
                                                     sst_detector as tdet)
from tests.test_torch_sst import FULL, TINY, _random_params, _t
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("ncls", [1, 3])
def test_anchor_head_decode_on_shared_maps(ncls):
    rng = np.random.RandomState(ncls)
    acfg = (jah.AnchorConfig() if ncls == 1
            else jah.waymo_3class_anchor_config())
    anchors = np.asarray(jah.generate_anchors(
        (20, 16), (-16, -12.8, -2, 16, 12.8, 4), acfg))
    A = anchors.shape[0]
    # a mostly empty map: most scores tie at one value, so the order of
    # ties decides the top-K; heading deltas beyond +-pi/2 exercise the mod
    cls = np.full((A, ncls), -4.59, np.float32)
    hot = rng.choice(A, 40, replace=False)
    cls[hot] = rng.randn(40, ncls) * 2
    reg = (rng.randn(A, 7) * 0.3).astype(np.float32)
    reg[:, 6] = rng.uniform(-4, 4, A)
    dirp = rng.randn(A, 2).astype(np.float32)
    ref = jah.anchor_head_decode(jnp.asarray(cls), jnp.asarray(reg),
                                 jnp.asarray(dirp), jnp.asarray(anchors),
                                 acfg, max_out=100)
    tcfg = tah.AnchorConfig(**dataclasses.asdict(acfg))
    got = tah.anchor_head_decode(_t(cls), _t(reg), _t(dirp), _t(anchors),
                                 tcfg, max_out=100)
    boxes, scores, labels, valid = (x.numpy() for x in got)
    assert boxes.shape == (100, 7)
    np.testing.assert_array_equal(scores, np.asarray(ref[1]))
    np.testing.assert_array_equal(labels, np.asarray(ref[2]))
    np.testing.assert_array_equal(valid, np.asarray(ref[3]))
    # float32 decode math: 1e-5
    np.testing.assert_allclose(boxes, np.asarray(ref[0]), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("cfg", [TINY, FULL], ids=["tiny", "default"])
def test_convert_round_trip(cfg):
    model = jdet.SSTDetector(cfg)
    s = cfg.sst
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((s.max_points, 5), jnp.float32),
        jax.ShapeDtypeStruct((s.max_points,), jnp.bool_))["params"]
    params = jax.tree_util.tree_map(np.asarray, _random_params(shapes, 1))
    sd = convert.flax_to_state_dict(params)
    # the port's module takes every converted tensor, shape for shape
    tcfg = tdet.tiny_sst_detector_config() if cfg is TINY else \
        tdet.SSTDetectorConfig()
    tmodel = tdet.SSTDetector(tcfg, device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    back = convert.state_dict_to_flax(tmodel.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
