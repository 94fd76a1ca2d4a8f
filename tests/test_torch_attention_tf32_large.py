"""The 3xTF32 emulation against float64 at large logits (moved out of
``test_torch_attention_tf32.py``, whose emulation it uses).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import pytest
import torch

from objectcentricocccompletion_torch.ops import window_attention as wa
from tests.test_torch_attention_tf32 import (BWD_ATOL, FWD_ATOL, _inputs,
                                             emulate_bwd, emulate_fwd)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def _large_logits(W, T, C, H, seed, target=60.0):
    """N(0, 1) inputs with q scaled so that the largest |logit| of a valid
    key is about ``target``."""
    q, k, v, g, mask = _inputs(W, T, C, seed)
    hd = C // H
    logits = torch.einsum("wthd,wshd->whts", q.view(W, T, H, hd),
                          k.view(W, T, H, hd)) / hd ** 0.5
    top = logits.masked_fill(~mask[:, None, None, :], 0).abs().max()
    return q * (target / top), k, v, g, mask


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_three_products_hold_float32_accuracy_at_large_logits(direction):
    """Against float64: 3xTF32 within twice plain float32's error; one TF32
    product (hi . hi, the rounding of a single tensor-core pass) fails the
    float32 bar by orders of magnitude."""
    W, T, C, H = 48, 144, 128, 8
    q, k, v, g, mask = _large_logits(W, T, C, H, seed=11)
    x64 = [t.double() for t in (q, k, v, g)]
    if direction == "forward":
        bar = FWD_ATOL
        ref = [wa.window_attention_plain(*x64[:3], mask, H)]
        fp32 = [wa.window_attention_plain(q, k, v, mask, H)]
        tf3 = [emulate_fwd(q, k, v, mask, H)]
        tf1 = [emulate_fwd(q, k, v, mask, H, terms=1)]
    else:
        bar = BWD_ATOL
        ref = wa.window_attention_bwd_plain(*x64[:3], mask, x64[3], H)
        fp32 = wa.window_attention_bwd_plain(q, k, v, mask, g, H)
        tf3 = emulate_bwd(q, k, v, mask, g, H)
        tf1 = emulate_bwd(q, k, v, mask, g, H, terms=1)

    def err(outs):
        return max((a.double() - r).abs().max().item()
                   for a, r in zip(outs, ref))
    e32, e3, e1 = err(fp32), err(tf3), err(tf1)
    assert e3 <= 2 * e32, (e3, e32)
    assert e1 > bar and e1 > 100 * e32, (e1, e32)
