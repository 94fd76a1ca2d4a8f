"""The window attention's plain backward against the JAX package's chunked
backward (moved out of ``test_torch_window_attention.py``).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import jax
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.ops.pallas_attention import (
    xla_chunked_window_attention_bwd)
from objectcentricocccompletion_torch.ops import window_attention as wa
from tests.test_torch_window_attention import (_bwd_inputs,
                                               one_torch_thread)  # noqa: F401


@pytest.mark.parametrize("chunk", [None, 1, 3])
def test_bwd_plain_matches_the_chunked_backward(chunk):
    """``xla_chunked_window_attention_bwd`` on the windows with a valid key
    (it differs from the einsum VJP in fully masked ones), one chunk and
    chunks smaller than W on both sides."""
    W, T, C, H = 11, 24, 32, 4
    q, k, v, mask, g = _bwd_inputs(W, T, C, seed=5, fully_masked=(2,))
    # one jitted JAX program (eager JAX compiles one per op and shape)
    ref = [np.asarray(x) for x in jax.jit(
        xla_chunked_window_attention_bwd, static_argnums=(5, 6))(
        q, k, v, mask, g, H, chunk)]
    got = wa.window_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, mask, g)), H, chunk=chunk)
    live = mask.any(1)
    for r, o in zip(ref, got):
        np.testing.assert_allclose(o.numpy()[live], r[live], atol=1e-5,
                                   rtol=0)
