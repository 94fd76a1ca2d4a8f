"""The port's OcOccNet training step held against the JAX package on the
CPU: the rotated IoU, the counter-hash dropout and its placements, the
losses, every parameter's gradient, the no-decay and frozen-AE parameter
sets, and one full train step.

Inputs are made from a numpy seed (the port's ``synthetic_batch``, which
gives the JAX package's arrays) and go through the JAX function and its
counterpart in ``objectcentricocccompletion_torch``; weights cross over
through ``convert.py``. Each JAX reference is jitted once for the file;
nothing runs at full width (the full ``OcOccNetConfig()`` tree is traced
by ``jax.eval_shape`` only).

Bars: the loss dict in float32 within 2e-4 (the forward's bar) and in
bfloat16 within 0.1; gradients within 1e-4 absolute
(``tests/test_grad_transplant_parity.py``); the IoU within 1e-5; the hash
bits exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from objectcentricocccompletion_tpu.configs import ococcnet_config as jcfgm
from objectcentricocccompletion_tpu.core import boxes as jboxes
from objectcentricocccompletion_tpu.models import layers as jlayers
from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_tpu.training import optim as joptim
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.core import boxes as tboxes
from objectcentricocccompletion_torch.models import layers as tlayers
from objectcentricocccompletion_torch.models import ococcnet as tnet
from objectcentricocccompletion_torch.parallel import train as ttrain
from objectcentricocccompletion_torch.training import optim as toptim
from tests.test_torch_ococcnet import (_batch, _jbatch, _params, _t,
                                       _torch_config)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

FP32_TOL = 2e-4
BF16_TOL = 0.1
GRAD_TOL = 1e-4
IOU_TOL = 1e-5
NO_DROPOUT = dict(occ_dropout=0.0, attn_dropout=0.0, cls_dropout=0.0,
                  reg_dropout=0.0, latent_dropout=0.0, fusion_dropout=0.0)
TINY = jcfgm.tiny_config()
_NODROP = dataclasses.replace(TINY, **NO_DROPOUT)
# dropout 0 (the gradient bar's setting): dense, packed over budget (8
# frames of 16-64 points into 128 slots), and the CTRL variant, which has
# the corner loss on
CONFIGS = {
    "dense": _NODROP,
    "packed": dataclasses.replace(_NODROP, packed_point_budget=128,
                                  packed_quantum=16),
    "ctrl": dataclasses.replace(_NODROP, variant="ctrl",
                                corner_loss_weight=1.0),
}


def _variant(cfg):
    return "ctrl" if cfg.variant == "ctrl" else "ococc"


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name):
    """The JAX loss and its gradient, jitted once per layout."""
    model = jnet.OcOccNetWithLoss(CONFIGS[name])

    def loss(p, b):
        return model.apply({"params": p}, b, train=True)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _port_model(cfg, params):
    model = tnet.OcOccNetWithLoss(_torch_config(cfg), device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(params))
    return model


def _compare_losses(got, ref, atol):
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(float(got[k]), float(r), atol=atol,
                                   rtol=0, err_msg=k)


# --- rotated IoU -----------------------------------------------------------

def _iou_pairs():
    """Random pairs, then identical, disjoint, edge- and corner-touching,
    zero-size, 45-degree and contained pairs."""
    rng = np.random.RandomState(0)
    n = 64
    a = np.concatenate([rng.uniform(-3, 3, (n, 3)),
                        rng.uniform(0.5, 4, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    b = a + np.concatenate([rng.normal(0, 0.7, (n, 3)),
                            rng.normal(0, 0.3, (n, 3)),
                            rng.normal(0, 0.5, (n, 1))], -1)
    b[:, 3:6] = np.abs(b[:, 3:6])
    box = np.array([1.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.3])

    def moved(dx=0.0, dy=0.0, dz=0.0, size=None, yaw=None):
        c = box.copy()
        c[:3] += (dx, dy, dz)
        if size is not None:
            c[3:6] = size
        if yaw is not None:
            c[6] = yaw
        return c

    flat = box.copy()
    flat[6] = 0.0
    special = [
        (box, box),                                        # identical
        (box, moved(dx=50.0)),                             # disjoint
        (box, moved(dz=5.0)),                              # above it
        (flat, moved(dx=4.0, yaw=0.0)),                    # edge-touching
        (flat, moved(dx=4.0, dy=2.0, yaw=0.0)),            # corner-touching
        (flat, moved(dz=1.5, yaw=0.0)),                    # face-touching
        (box, moved(size=(0.0, 0.0, 0.0))),                # zero size
        (moved(size=(0.0, 2.0, 1.5)), box),                # zero width
        (moved(size=(0.0, 0.0, 0.0)), moved(size=(0.0, 0.0, 0.0))),
        (flat, moved(yaw=np.pi / 4)),                      # 45 degrees
        (moved(size=(2.0, 2.0, 1.5), yaw=0.0),
         moved(size=(2.0, 2.0, 1.5), yaw=np.pi / 4)),      # square, 45 deg
        (box, moved(size=(1.0, 0.5, 0.5))),                # contained
        (flat, moved(yaw=np.pi)),                          # flipped
    ]
    s1, s2 = (np.stack(x) for x in zip(*special))
    return (np.concatenate([a, s1]).astype(np.float32),
            np.concatenate([b, s2]).astype(np.float32))


def test_aligned_iou_3d_matches():
    b1, b2 = _iou_pairs()
    ref = np.asarray(jax.jit(jboxes.aligned_iou_3d)(b1, b2))
    got = tboxes.aligned_iou_3d(_t(b1), _t(b2)).numpy()
    np.testing.assert_allclose(got, ref, atol=IOU_TOL, rtol=0)
    # the cases' own values: identical 1, disjoint and zero-size 0
    n = len(b1) - 13
    np.testing.assert_allclose(got[n:n + 3], [1.0, 0.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(got[n + 6:n + 9], 0.0, atol=1e-6)
    assert 0.0 < got[:n].max() and 0.0 < got[n + 9] < 1.0
    # broadcast [B, L, 7] against [B, L, 7], as the loss calls it
    got2 = tboxes.aligned_iou_3d(_t(b1[:64]).reshape(8, 8, 7),
                                 _t(b2[:64]).reshape(8, 8, 7))
    np.testing.assert_allclose(got2.reshape(-1).numpy(), ref[:64],
                               atol=IOU_TOL, rtol=0)


def test_corners_3d_match():
    b1, _ = _iou_pairs()
    np.testing.assert_allclose(
        tboxes.corners_3d(_t(b1)).numpy(),
        np.asarray(jax.jit(jboxes.corners_3d)(b1)), atol=1e-5, rtol=0)


# --- counter-hash dropout -------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (2, 4, 8, 8),
                                   ((1 << 16) + 3,)])
def test_hash_bits_bit_exact(shape):
    words = [(0, 0), (1, 2), (0xFFFFFFFF, 0x80000000), (123456789, 42),
             (0x85EBCA6B, 0xC2B2AE35)]
    for k0, k1 in words:
        ref = np.asarray(jlayers._hash_bits(
            jnp.asarray([k0, k1], jnp.uint32), shape)).astype(np.int64)
        got = tlayers.hash_bits(torch.tensor([k0, k1]), shape)
        assert got.dtype == torch.int64 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), ref)
    # the offset continues the counter (the per-site key derivation)
    key = torch.tensor([5, 6])
    whole = tlayers.hash_bits(key, (int(np.prod(shape)) + 9,))
    np.testing.assert_array_equal(
        tlayers.hash_bits(key, shape, 9).reshape(-1).numpy(),
        whole[9:].numpy())


def _spy_hash_bits(monkeypatch):
    """Record the key words and shapes the JAX package's dropout draws,
    in call order (under jit the words are traced values)."""
    calls = []
    orig = jlayers._hash_bits

    def spy(key, shape):
        kd = key if jnp.issubdtype(key.dtype, jnp.integer) \
            else jax.random.key_data(key)
        calls.append((kd.reshape(-1).astype(jnp.uint32), tuple(shape)))
        return orig(key, shape)

    monkeypatch.setattr(jlayers, "_hash_bits", spy)
    return calls


def _port_words(words):
    """JAX key words -> the port's int64 [2] keys (first and last word)."""
    return [torch.tensor([int(w[0]), int(w[-1])]) for w in np.asarray(words)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_barrier_dropout(monkeypatch, dtype):
    """Keep mask, threshold and scale: 1/0.9 rounds to 1.109375 in bf16
    before the multiply."""
    calls = _spy_hash_bits(monkeypatch)
    x = np.random.RandomState(1).randn(4, 33, 17).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    for rate in (0.1, 0.5):
        calls.clear()
        ref = jlayers.BarrierDropout(rate).apply(
            {}, xj, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(3)})
        keys = tlayers.DropoutKeys(words=_port_words([calls[0][0]]))
        got = tlayers.dropout(_t(x).to(getattr(torch, dtype)), rate, keys)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))
        kept = got.float().numpy() != 0
        assert abs(kept.mean() - (1 - rate)) < 0.05
    if dtype == "bfloat16":
        scale = got.float().numpy()[kept] / _t(x).to(
            torch.bfloat16).float().numpy()[kept]
        np.testing.assert_allclose(scale, 2.0)
        calls.clear()
        jlayers.BarrierDropout(0.1).apply(
            {}, jnp.ones((64,), dtype), deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(0)})
        got = tlayers.dropout(torch.ones(64, dtype=torch.bfloat16), 0.1,
                              tlayers.DropoutKeys(
                                  words=_port_words([calls[0][0]])))
        assert set(got.float().unique().tolist()) <= {0.0, 1.109375}


def test_dropout_keys_on_the_device_from_seed_and_step():
    base = torch.tensor([7, 3])
    keys = tlayers.DropoutKeys(base)
    first, second = keys(), keys()
    assert first.dtype == torch.int64 and first.shape == (2,)
    assert not torch.equal(first, second)
    np.testing.assert_array_equal(
        torch.cat([first, second]).numpy(),
        tlayers.hash_bits(base, (4,)).numpy())
    other = tlayers.DropoutKeys(torch.tensor([7, 4]))()
    assert not torch.equal(first, other)
    with pytest.raises(ValueError):
        tlayers.DropoutKeys()


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


def test_training_forward_needs_keys_with_dropout():
    tiny = tnet.OcOccNetWithLoss(_torch_config(TINY), "cpu")
    b = _batch(TINY)
    with pytest.raises(ValueError, match="DropoutKeys"):
        tiny(b)
    with torch.no_grad():   # evaluation draws nothing
        tiny(b, train=False)


# --- losses and gradients -----------------------------------------------

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


# --- optimizer parameter sets -------------------------------------------

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


# --- one train step -----------------------------------------------------

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
