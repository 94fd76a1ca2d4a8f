"""The window attention's plain forward against the JAX reference and the
Pallas kernel in interpret mode (moved out of
``test_torch_window_attention.py``).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.ops.pallas_attention import (
    jnp_window_attention, pallas_window_attention)
from objectcentricocccompletion_torch.ops import window_attention as wa
from tests.test_torch_window_attention import (SHAPES, _inputs,
                                               one_torch_thread)  # noqa: F401


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
