"""The port's window attention (``ops/window_attention.py``) held against
the JAX package's ``jnp_window_attention`` and the Pallas kernel in
interpret mode, on the CPU. ``chip_smoke.py`` holds the CUDA kernel against
the same plain version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.ops.pallas_attention import (
    jnp_window_attention, pallas_window_attention)
from objectcentricocccompletion_torch.ops import window_attention as wa

# (W, T, C, H): head dims 8 and 16 (the production one), capacities of the
# tiny config (16), the small level (32) and a ragged one
SHAPES = [(4, 16, 32, 4), (3, 32, 128, 8), (2, 20, 64, 4)]


def _inputs(W, T, C, seed, fully_masked=(0,)):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(W, T, C).astype(np.float32) for _ in range(3))
    mask = rng.rand(W, T) > 0.3
    mask[:, -1] = True
    for w in fully_masked:           # padded window slots are all masked
        mask[w] = False
    return q, k, v, mask


@pytest.mark.parametrize("W,T,C,H", SHAPES)
def test_plain_matches_jnp_and_pallas_interpret(W, T, C, H):
    q, k, v, mask = _inputs(W, T, C, seed=W * T)
    ref = np.asarray(jnp_window_attention(*map(jnp.asarray, (q, k, v, mask)),
                                          H))
    pal = np.asarray(pallas_window_attention(
        *map(jnp.asarray, (q, k, v, mask)), H, interpret=True))
    got = wa.window_attention_plain(*map(torch.from_numpy, (q, k, v, mask)),
                                    H)
    assert got.dtype == torch.float32 and got.shape == (W, T, C)
    # the forward bar of tests/test_pallas_attention.py: 2e-5
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)
    # the Pallas kernel adds -1e9 where the reference replaces with it; the
    # two agree on every window with a valid key
    live = mask.any(1)
    np.testing.assert_allclose(got.numpy()[live], pal[live], atol=2e-5,
                               rtol=2e-5)


def test_fully_masked_window_is_the_mean_of_v():
    q, k, v, mask = _inputs(3, 16, 32, seed=1, fully_masked=(0, 2))
    out = wa.window_attention_plain(*map(torch.from_numpy, (q, k, v, mask)),
                                    4).numpy()
    assert np.isfinite(out).all()
    for w in (0, 2):
        # uniform weights over every key: float32 sums, atol 1e-6
        np.testing.assert_allclose(
            out[w], np.broadcast_to(v[w].mean(0), out[w].shape), atol=1e-6)


def test_bf16_plain_computes_in_float32():
    q, k, v, mask = _inputs(3, 32, 128, seed=2)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    m = torch.from_numpy(mask)
    b = [x.bfloat16() for x in t]
    out = wa.window_attention_plain(*b, m, 8)
    assert out.dtype == torch.bfloat16
    ref = wa.window_attention_plain(*(x.float() for x in b), m, 8)
    # the only rounding is the final cast to bf16 (8 bits of mantissa)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2,
                               rtol=2 ** -8)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    q, k, v, mask = map(torch.from_numpy, _inputs(2, 16, 32, seed=3))
    before = dict(wa.LAUNCHES)
    out = wa.window_attention(q, k, v, mask, 4)
    assert torch.equal(out, wa.window_attention_plain(q, k, v, mask, 4))
    assert dict(wa.LAUNCHES) == before


def _bad_inputs(case):
    q = torch.zeros(2, 16, 32)
    k, v = q.clone(), q.clone()
    mask = torch.ones(2, 16, dtype=torch.bool)
    heads = 4
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "shape":
        k = torch.zeros(2, 8, 32)
    elif case == "mask_dtype":
        mask = mask.float()
    elif case == "contiguity":
        q = torch.zeros(2, 32, 16).transpose(1, 2)
    elif case == "heads":
        heads = 3
    elif case == "head_dim":
        heads = 1                      # hd = 32 is fine; 64 is not
        q, k, v = (torch.zeros(2, 16, 64) for _ in range(3))
    elif case == "capacity":
        q, k, v = (torch.zeros(1, 600, 32) for _ in range(3))
        mask = torch.ones(1, 600, dtype=torch.bool)
    return q, k, v, mask, heads


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "shape",
                                  "mask_dtype", "contiguity", "heads",
                                  "head_dim", "capacity"])
def test_kernel_input_checks_raise(case):
    with pytest.raises((ValueError, TypeError)):
        wa.check_inputs(*_bad_inputs(case))


def test_kernel_input_checks_accept_the_production_shapes():
    for W, T in ((3200, 32), (800, 144)):
        for dt in (torch.float32, torch.bfloat16):
            q = torch.zeros(W, T, 128, dtype=dt)
            wa.check_inputs(q, q, q, torch.ones(W, T, dtype=torch.bool), 8)
