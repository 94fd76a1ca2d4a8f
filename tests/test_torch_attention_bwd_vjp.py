"""The window attention's backward (plain version and autograd Function)
against the einsum VJP, and a float64 gradcheck (moved out of
``test_torch_window_attention.py``, whose helpers they use).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import numpy as np
import pytest
import torch

from objectcentricocccompletion_torch.ops import window_attention as wa
from tests.test_torch_window_attention import (SHAPES, _bwd_inputs,
                                               _einsum_vjp, _function_grads,
                                               _inputs,
                                               one_torch_thread)  # noqa: F401


@pytest.mark.parametrize("W,T,C,H", SHAPES)
def test_bwd_plain_and_function_match_the_einsum_vjp(W, T, C, H):
    q, k, v, mask, g = _bwd_inputs(W, T, C, seed=7 * W + T)
    ref = _einsum_vjp(q, k, v, mask, g, H)
    plain = wa.window_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, mask, g)), H)
    func = _function_grads(q, k, v, mask, g, H)
    for name, r, p, f in zip("qkv", ref, plain, func):
        assert p.dtype == torch.float32 and p.shape == (W, T, C)
        # float32 sums in another order: atol 1e-5
        np.testing.assert_allclose(p.numpy(), r, atol=1e-5, rtol=0,
                                   err_msg=f"plain d{name}")
        np.testing.assert_allclose(f, r, atol=1e-5, rtol=0,
                                   err_msg=f"Function d{name}")


def test_function_gradcheck_float64():
    """The Function's backward is the derivative of its forward (finite
    differences in float64, fully masked window included)."""
    q, k, v, mask = _inputs(3, 5, 8, seed=4, fully_masked=(1,))
    t = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    m = torch.from_numpy(mask)
    assert torch.autograd.gradcheck(
        lambda a, b, c: wa.window_attention(a, b, c, m, 2), t)
