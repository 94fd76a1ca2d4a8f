"""The no-decay and frozen parameter sets over the full OcOccNet tree held
against the JAX package (moved out of ``test_torch_ococc_train.py``).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from objectcentricocccompletion_tpu.configs import ococcnet_config as jcfgm
from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_tpu.training import optim as joptim
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.models import ococcnet as tnet
from objectcentricocccompletion_torch.parallel import train as ttrain
from objectcentricocccompletion_torch.training import optim as toptim
from tests.test_torch_ococc_train import TINY
from tests.test_torch_ococcnet import _torch_config
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def _full_tree_names():
    """The full ``OcOccNetConfig()`` parameter tree's shapes (traced, not
    run) and the port's names of its leaves."""
    cfg = dataclasses.replace(jcfgm.OcOccNetConfig(),
                              packed_point_budget=None,
                              roi_point_budget=None)
    f32, S = jnp.float32, jax.ShapeDtypeStruct
    B, L, P, K = 1, 4, 16, 8
    batch = jnet.TrackletBatch(
        S((B, L, P, cfg.points_dim), f32), S((B, L, P), jnp.bool_),
        S((B, L, 7), f32), S((B, L), f32), S((B, L), jnp.int32),
        S((B, L, 7), f32), S((B, L), jnp.bool_), S((B, K, 3), f32),
        S((B, K), jnp.int32), S((B, K), jnp.bool_), S((B,), f32))
    model = jnet.OcOccNetWithLoss(cfg)
    shapes = jax.eval_shape(lambda bb: model.init(
        {"params": jax.random.PRNGKey(0)}, bb, train=False), batch)["params"]
    # each leaf's port name, through the converter: one-element stand-ins
    # that carry the leaf's index in JAX's flattening order
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    stand_in = jax.tree_util.tree_unflatten(tree, [
        np.full((1,) * len(s.shape), i, np.float32)
        for i, s in enumerate(leaves)])
    by_index = {int(v.reshape(-1)[0]): n for n, v in
                convert.flax_to_state_dict(stand_in).items()}
    return shapes, [by_index[i] for i in range(len(leaves))]


def test_decay_and_frozen_sets_match_over_the_full_tree():
    shapes, names = _full_tree_names()
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(names) == len(leaves) == 282
    decay = jax.tree_util.tree_leaves(joptim._no_decay_mask(shapes))
    assert [toptim.decays(n) for n in names] == decay
    # fixed_ae: the JAX optimizer's "frozen" label carries no Adam moments
    # (optax.set_to_zero); the "train" label's moments are shaped leaves
    frozen_cfg = dataclasses.replace(jcfgm.OcOccNetConfig(), fixed_ae=True)
    tx, _ = joptim.make_optimizer(1e-6, 10, frozen_prefixes=("ae_encoder",))
    state = jax.eval_shape(tx.init, shapes)
    mu = state.inner_states["train"].inner_state[1][0].mu
    trained = [not isinstance(x, optax.MaskedNode) for x in
               jax.tree_util.tree_leaves(
                   mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))]
    assert sum(trained) < len(trained)
    port_cfg = _torch_config(frozen_cfg)
    frozen = ttrain.frozen_prefixes(port_cfg)
    assert frozen == ("ae_encoder",)
    assert [not any(f in n for f in frozen) for n in names] == trained
    # the port's optimizer groups hold exactly the trained, decay-split
    # parameters of a model built from the same config (tiny widths)
    model = tnet.OcOccNetWithLoss(_torch_config(dataclasses.replace(
        TINY, fixed_ae=True)), "cpu")
    opt, _ = toptim.make_optimizer(model.named_parameters(), 1e-6, 10,
                                   frozen_prefixes=frozen)
    in_groups = {id(p) for g in opt.param_groups for p in g["params"]}
    for n, p in model.named_parameters():
        assert (id(p) in in_groups) == ("ae_encoder" not in n), n
