"""The arithmetic of the float32 tensor-core attention kernels
(``csrc/window_attention.cu``, ``csrc/window_attention_bwd.cu``, 3xTF32),
emulated on the CPU at their rounding points and held to the JAX package's
reference (``jnp_window_attention`` and ``jax.vjp`` of it) at the production
width (C=128, H=8), the two SST capacities and a ragged one, within half of
``chip_smoke.py``'s float32 bars. ``chip_smoke.py`` holds the kernels
themselves to the plain versions on the card.

The emulation follows the kernels: TF32 rounding (``cvt.rna``: round half
away from zero to 10 mantissa bits, on the float32 bit pattern), every
product as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b of hi = tf32(x), lo = tf32(x -
hi) accumulated in float32, the row max from single TF32 products
(hi_a.hi_b), logits in the log2 domain with an additive key bias (0, or the
masked logit for masked and padding keys), capacity padded to a multiple of
16 with zero rows, P.V with the keys of each 8-key step permuted (A's k = tig
is key 2 tig, k = tig + 4 is key 2 tig + 1) in both operands, and a fully
masked window's closed form (the mean over exactly T rows). Backward: phase
A's dq = scale / l * (sum e dP k - delta * sum e k), phase B's P from the
stored max + log2(sum).

A case with large logits shows why each product takes three TF32 products:
against float64, 3xTF32 stays within twice the error of plain float32,
while a single TF32 product misses the float32 bar."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.ops.pallas_attention import (
    jnp_window_attention)
from objectcentricocccompletion_torch.ops import window_attention as wa
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

LOG2E = 1.4426950408889634
MASKED_LOGIT2 = float(np.float32(-1e9) * np.float32(LOG2E))
# chip_smoke.py's float32 bars: forward and backward max abs error
FWD_ATOL, BWD_ATOL = 1e-5, 1e-4
# A's k index within an 8-key step -> the key it reads (from the C tile's
# columns 2 tig, 2 tig + 1)
KEY_PERM = [0, 2, 4, 6, 1, 3, 5, 7]


def tf32(x):
    """cvt.rna.tf32.f32 of finite float32 values, as a float32 tensor."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm(a, b, terms=3):
    """a @ b as the kernels take it: 3xTF32 (lo.hi + hi.lo + hi.hi), or a
    single TF32 product with terms=1."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _permute_keys(x, dim):
    """x's key axis ``dim`` (a multiple of 8 long) reordered within each
    8-key step as the A fragment reads it (an index on a last axis of 8:
    ``index_select`` on the strided key axis of these views is about 30x
    slower on the CPU)."""
    steps = x.movedim(dim, -1).unflatten(-1, (-1, 8))
    return steps[..., KEY_PERM].flatten(-2).movedim(-1, dim)


def _heads(q, k, v, g, mask, H):
    """Heads split, capacity padded to Tp (a multiple of 16) with zero rows,
    the log2-domain key bias [W, 1, 1, Tp] and the fully masked windows."""
    W, T, C = q.shape
    hd = C // H
    Tp = -(-T // 16) * 16

    def split_heads(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, Tp - T))
        return x.view(W, Tp, H, hd).transpose(1, 2)      # [W, H, Tp, hd]
    valid = torch.nn.functional.pad(mask, (0, Tp - T))
    bias = torch.where(valid, 0.0, MASKED_LOGIT2)[:, None, None, :]
    return [split_heads(x) for x in (q, k, v, g)], bias, ~mask.any(1), hd


def _merge(x, T):
    W, H, Tp, hd = x.shape
    return x.transpose(1, 2).reshape(W, Tp, H * hd)[:, :T]


def emulate_fwd(q, k, v, mask, H, terms=3, permute_v=True):
    """The forward kernel's arithmetic on float32 [W, T, C] inputs ->
    float32 [W, T, C]. ``permute_v=False`` permutes P's keys but not V's
    rows (what the kernel must not do)."""
    T = q.shape[1]
    (qh, kh, vh, _), bias, closed, hd = _heads(q, k, v, q, mask, H)
    scale_log2 = np.float32(LOG2E / hd ** 0.5)
    kt = kh.transpose(-1, -2)
    m = (mm(qh, kt, 1) * scale_log2 + bias).amax(-1, keepdim=True)
    e = torch.exp2(mm(qh, kt, terms) * scale_log2 + bias - m)
    l = e.sum(-1, keepdim=True).clamp_min(1e-20)
    vp = _permute_keys(vh, 2) if permute_v else vh
    out = _merge(mm(_permute_keys(e, 3), vp, terms) / l, T)
    out[closed] = v[closed].mean(1, keepdim=True)
    return out


def emulate_bwd(q, k, v, mask, g, H, terms=3):
    """The backward kernel's arithmetic -> (dq, dk, dv) float32 [W, T, C]."""
    T = q.shape[1]
    (qh, kh, vh, gh), bias, closed, hd = _heads(q, k, v, g, mask, H)
    scale = np.float32(1 / hd ** 0.5)
    scale_log2 = np.float32(scale * LOG2E)
    kt = kh.transpose(-1, -2)
    # phase A: a query strip against all keys
    m = (mm(qh, kt, 1) * scale_log2 + bias).amax(-1, keepdim=True)
    e = torch.exp2(mm(qh, kt, terms) * scale_log2 + bias - m)
    x = e * mm(gh, vh.transpose(-1, -2), terms)
    l = e.sum(-1, keepdim=True).clamp_min(1e-20)
    delta = x.sum(-1, keepdim=True) / l
    kp = _permute_keys(kh, 2)
    dq = (mm(_permute_keys(x, 3), kp, terms)
          - delta * mm(_permute_keys(e, 3), kp, terms)) * (scale / l)
    # phase B: a key strip against all queries, P^T from the stored
    # max + log2(sum), logits computed anew as k q^T
    m2 = (m + torch.log2(l)).transpose(-1, -2)
    p = torch.exp2(mm(kh, qh.transpose(-1, -2), terms) * scale_log2
                   + bias.transpose(-1, -2) - m2)
    ds = p * (mm(vh, gh.transpose(-1, -2), terms) - delta.transpose(-1, -2))
    dv = mm(_permute_keys(p, 3), _permute_keys(gh, 2), terms)
    dk = mm(_permute_keys(ds, 3), _permute_keys(qh, 2), terms) * scale
    dq, dk, dv = (_merge(t, T) for t in (dq, dk, dv))
    dq[closed] = 0.0
    dk[closed] = 0.0
    dv[closed] = g[closed].mean(1, keepdim=True)
    return dq, dk, dv


def _inputs(W, T, C, seed):
    """N(0, 1) q, k, v, g as chip_smoke.py draws them; per window a random
    token count in [1, T] at random positions; one window in eight fully
    masked."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(W, T, C).astype(np.float32))
                  for _ in range(4))
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


@pytest.mark.parametrize("W,T", [(48, 32), (24, 144), (32, 20)])
def test_emulated_kernels_match_the_jax_reference(W, T):
    """T=20 pads to 32 rows whose keys weigh 0; every shape has fully
    masked windows, which take the closed form (the mean over exactly T
    rows, not over the padded capacity)."""
    C, H = 128, 8
    q, k, v, g, mask = _inputs(W, T, C, seed=T)
    ref_out, ref_grads = _jax_ref(q, k, v, mask, g, H)
    out = emulate_fwd(q, k, v, mask, H)
    assert np.abs(out.numpy() - ref_out).max() <= FWD_ATOL / 2
    full = ~mask.any(1)
    assert full.sum() == W // 8
    np.testing.assert_allclose(out[full].numpy(), v[full].mean(
        1, keepdim=True).expand(-1, T, -1).numpy(), rtol=0, atol=1e-6)
    for name, got, ref in zip(("dq", "dk", "dv"),
                              emulate_bwd(q, k, v, mask, g, H), ref_grads):
        err = np.abs(got.numpy() - ref).max()
        assert err <= BWD_ATOL / 2, (name, err)


def test_p_and_v_take_the_same_key_permutation():
    """P's keys permuted to match the accumulator layout are only right
    when V's rows follow the same permutation."""
    W, T, C, H = 24, 32, 128, 8
    q, k, v, g, mask = _inputs(W, T, C, seed=5)
    ref = wa.window_attention_plain(q, k, v, mask, H)
    assert (emulate_fwd(q, k, v, mask, H) - ref).abs().max() <= FWD_ATOL / 2
    assert (emulate_fwd(q, k, v, mask, H, permute_v=False)
            - ref).abs().max() > 0.1


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
