"""The arithmetic of the bf16 tensor-core attention kernels
(``csrc/window_attention_tc.cu``, ``csrc/window_attention_bwd_tc.cu``),
emulated on the CPU at their rounding points and held to the JAX package's
reference (``jnp_window_attention`` and ``jax.vjp`` of it) at the production
width (C=128, H=8) and the two SST capacities, within half of
``chip_smoke.py``'s bf16 tolerances. ``chip_smoke.py`` holds the kernels
themselves to the plain versions on the card.

The emulation follows the kernels: inputs bf16, products accumulated in
float32, logits in the log2 domain with an additive key bias (0, or the
masked logit for masked and padding keys), capacity padded to a multiple of
16 with zero rows, and a fully masked window's closed form (the mean over
exactly T rows). Forward: P = exp2(logit - max) rounded to bf16 for P.V,
divided by the float32 sum. Backward: e and e*dP (phase A) and P and dS
(phase B) enter their products as bf16 hi+lo pairs, and
dq = scale / l * (sum e dP k - delta * sum e k)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.ops.pallas_attention import (
    jnp_window_attention)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

LOG2E = 1.4426950408889634
MASKED_LOGIT2 = np.float32(-1e9) * np.float32(LOG2E)
# chip_smoke.py's bf16 bars: forward atol, backward rtol on max|ref|
FWD_ATOL, BWD_RTOL = 2e-2, 2 ** -7


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(x):
    """x as a bf16 pair: hi = bf16(x), lo = bf16(x - hi)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _pair_mm(a, b):
    """(hi(a) + lo(a)) @ b: two bf16 products accumulated in float32."""
    hi, lo = _hi_lo(a)
    return hi @ b + lo @ b


def _padded(q, k, v, mask, g, H, pad_as_keys):
    """Heads split, capacity padded to Tp (a multiple of 16) with zero rows,
    and the log2-domain key bias [W, 1, 1, Tp]. A fully masked window is
    closed-form unless ``pad_as_keys``: then it runs the softmax over all
    Tp keys, padding included (the trap the kernels avoid)."""
    W, T, C = q.shape
    hd = C // H
    Tp = -(-T // 16) * 16

    def heads(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, Tp - T))
        return x.view(W, Tp, H, hd).transpose(1, 2)       # [W, H, Tp, hd]
    valid = torch.nn.functional.pad(mask, (0, Tp - T))
    bias = torch.where(valid, 0.0, float(MASKED_LOGIT2))[:, None, None, :]
    closed = ~mask.any(1) if not pad_as_keys else torch.zeros(W, dtype=bool)
    return [heads(x) for x in (q, k, v, g)], bias, closed, hd, Tp


def emulate_fwd(q, k, v, mask, H, pad_as_keys=False):
    """The forward kernel's arithmetic; q/k/v float32 tensors holding bf16
    values [W, T, C], mask bool [W, T] -> float32 [W, T, C] (bf16 values)."""
    W, T, C = q.shape
    (qh, kh, vh, _), bias, closed, hd, Tp = _padded(q, k, v, mask, q, H,
                                                   pad_as_keys)
    t = (qh @ kh.transpose(-1, -2)) * np.float32(LOG2E / hd ** 0.5) + bias
    e = torch.exp2(t - t.amax(-1, keepdim=True))
    out = (_bf16(e) @ vh) / e.sum(-1, keepdim=True)
    out = out.transpose(1, 2).reshape(W, Tp, C)[:, :T]
    out[closed] = v[closed].mean(1, keepdim=True)
    return _bf16(out)


def emulate_bwd(q, k, v, mask, g, H):
    """The backward kernel's arithmetic -> (dq, dk, dv) float32 [W, T, C]
    (bf16 values)."""
    W, T, C = q.shape
    (qh, kh, vh, gh), bias, closed, hd, Tp = _padded(q, k, v, mask, g, H,
                                                     False)
    scale = np.float32(1 / hd ** 0.5)
    t = (qh @ kh.transpose(-1, -2)) * np.float32(LOG2E / hd ** 0.5) + bias
    m = t.amax(-1, keepdim=True)
    dp = gh @ vh.transpose(-1, -2)
    # phase A: one exponential, dq from two products that need no delta
    e = torch.exp2(t - m)
    x = e * dp
    l = e.sum(-1, keepdim=True)
    delta = x.sum(-1, keepdim=True) / l
    dq = scale / l * (_pair_mm(x, kh) - delta * _pair_mm(e, kh))
    # phase B: P from the saved max + log2(sum), dS = P (dP - delta)
    p = torch.exp2(t - (m + torch.log2(l)))
    ds = p * (dp - delta)
    dv = _pair_mm(p.transpose(-1, -2), gh)
    dk = scale * _pair_mm(ds.transpose(-1, -2), qh)
    outs = [x.transpose(1, 2).reshape(W, Tp, C)[:, :T] for x in (dq, dk, dv)]
    outs[0][closed] = 0.0
    outs[1][closed] = 0.0
    outs[2][closed] = g[closed].mean(1, keepdim=True)
    return [_bf16(x) for x in outs]


def _inputs(W, T, C, seed):
    """bf16-valued N(0, 1) q, k, v, g; per window a random token count in
    [1, T] at random positions; one window in eight fully masked."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(W, T, C).astype(np.float32))
                  for _ in range(4))
    q, k, v, g = (_bf16(x) for x in (q, k, v, g))
    count = rng.randint(1, T + 1, (W, 1))
    mask = rng.rand(W, T).argsort(-1) < count
    mask[7::8] = False
    return q, k, v, g, torch.from_numpy(mask)


@functools.partial(jax.jit, static_argnums=5)
def _jax_vjp(q, k, v, mask, g, H):
    out, vjp = jax.vjp(
        lambda a, b, c: jnp_window_attention(a, b, c, mask, H), q, k, v)
    return out, vjp(g)


def _jax_ref(q, k, v, mask, g, H):
    """``jnp_window_attention`` and ``jax.vjp`` of it (one compiled call)."""
    out, grads = _jax_vjp(*(jnp.asarray(x.numpy())
                            for x in (q, k, v, mask, g)), H)
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("W,T", [(48, 32), (24, 144)])
def test_emulated_kernels_match_the_jax_reference(W, T):
    C, H = 128, 8
    q, k, v, g, mask = _inputs(W, T, C, seed=T)
    ref_out, ref_grads = _jax_ref(q, k, v, mask, g, H)
    out = emulate_fwd(q, k, v, mask, H).numpy()
    assert np.abs(out - ref_out).max() <= FWD_ATOL / 2
    for name, got, ref in zip(("dq", "dk", "dv"),
                              emulate_bwd(q, k, v, mask, g, H), ref_grads):
        err = np.abs(got.numpy() - ref).max()
        assert err <= BWD_RTOL / 2 * np.abs(ref).max(), (name, err)


def test_ragged_capacity_excludes_padding_keys():
    """T=20 pads to 32 rows. Padding keys weigh exactly 0: live windows
    match the reference, and a fully masked window is the mean over exactly
    20 rows. Counting the padding as masked keys instead averages over 32
    rows, 12 of them zero: a different result."""
    W, T, C, H = 16, 20, 128, 8
    q, k, v, g, mask = _inputs(W, T, C, seed=3)
    ref_out, ref_grads = _jax_ref(q, k, v, mask, g, H)
    out = emulate_fwd(q, k, v, mask, H).numpy()
    assert np.abs(out - ref_out).max() <= FWD_ATOL / 2
    for got, ref in zip(emulate_bwd(q, k, v, mask, g, H), ref_grads):
        assert np.abs(got.numpy() - ref).max() <= \
            BWD_RTOL / 2 * np.abs(ref).max()
    full = ~mask.any(1)
    assert full.sum() == 2
    mean_v = v[full].mean(1, keepdim=True).expand(-1, T, -1)
    np.testing.assert_allclose(out[full.numpy()], _bf16(mean_v).numpy())
    trap = emulate_fwd(q, k, v, mask, H, pad_as_keys=True).numpy()
    np.testing.assert_allclose(trap[~full.numpy()], out[~full.numpy()])
    np.testing.assert_allclose(trap[full.numpy()],
                               _bf16(mean_v * T / 32).numpy(), atol=1e-2)
    assert np.abs(trap[full.numpy()] - ref_out[full.numpy()]).max() > 0.1
