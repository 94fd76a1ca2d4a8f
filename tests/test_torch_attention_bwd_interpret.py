"""The window attention's plain backward against the two Pallas backward
kernels in interpret mode (moved out of
``test_torch_window_attention.py``).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_torch.ops import window_attention as wa
from tests.test_torch_window_attention import (_bwd_inputs,
                                               one_torch_thread)  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
from repro_attn_bwd import (  # noqa: E402
    pallas_window_attention_bwd, pallas_window_attention_bwd_fullstore)


@pytest.mark.parametrize("form", ["stacked", "fullstore"])
def test_bwd_plain_matches_the_repro_kernels_interpret(form):
    """The two TPU backward kernels the CUDA kernel replaces, run in
    interpret mode, on every window with a valid key (they add the -1e9
    bias where the port replaces the logit, which differs only in fully
    masked windows)."""
    W, T, C, H = 3, 16, 32, 4
    q, k, v, mask, g = _bwd_inputs(W, T, C, seed=9, fully_masked=(1,))
    fn = {"stacked": pallas_window_attention_bwd,
          "fullstore": pallas_window_attention_bwd_fullstore}[form]
    ref = [np.asarray(x) for x in fn(*map(jnp.asarray, (q, k, v, mask, g)),
                                     H, interpret=True)]
    got = wa.window_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, mask, g)), H)
    live = mask.any(1)
    for r, o in zip(ref, got):
        np.testing.assert_allclose(o.numpy()[live], r[live], atol=1e-5,
                                   rtol=0)
