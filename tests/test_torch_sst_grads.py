"""The tiny SST detector's loss and gradients and the no-decay split held
against the JAX package; they share the module-scoped ``tiny_grads``
fixture (moved out of ``test_torch_sst_train.py``).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.models import sst_detector as jdet
from objectcentricocccompletion_tpu.training import optim as joptim
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import sst_detector as tdet
from objectcentricocccompletion_torch.training import optim as toptim
from tests.test_torch_sst import (_frame, _param_tree, _random_params,
                                   _torch_config)
from tests.test_torch_sst_train import TINY
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


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
    params = jax.tree_util.tree_map(np.asarray,
                                    _random_params(_param_tree(TINY), 6))

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
