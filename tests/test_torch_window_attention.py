"""The port's window attention (``ops/window_attention.py``) held against
the JAX package's ``jnp_window_attention`` and the Pallas kernel in
interpret mode, on the CPU; its backward against ``jax.vjp`` of the einsum
form, the chunked backward and the repro backward kernels (interpret
mode). ``chip_smoke.py`` holds the CUDA kernels against the same plain
versions on the card."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.ops.pallas_attention import (
    jnp_window_attention, pallas_window_attention,
    xla_chunked_window_attention_bwd)
from objectcentricocccompletion_torch.ops import window_attention as wa

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
from repro_attn_bwd import (  # noqa: E402
    pallas_window_attention_bwd, pallas_window_attention_bwd_fullstore)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread while the module runs (restored
    after). The tier-1 suite runs 6 pytest-xdist workers on 8 cores; a
    worker's pool of 8 spinning threads slows its own tiny CPU ops
    several-fold and takes cores from the other workers. The port's test
    modules import this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# --- backward -------------------------------------------------------------

def _bwd_inputs(W, T, C, seed, fully_masked=(0,)):
    q, k, v, mask = _inputs(W, T, C, seed, fully_masked)
    g = np.random.RandomState(seed + 1).randn(W, T, C).astype(np.float32)
    return q, k, v, mask, g


def _einsum_vjp(q, k, v, mask, g, H):
    _, vjp = jax.vjp(lambda a, b, c: jnp_window_attention(
        a, b, c, jnp.asarray(mask), H), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _function_grads(q, k, v, mask, g, H):
    """dq, dk, dv through ``window_attention``'s autograd Function."""
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = wa.window_attention(*t, torch.from_numpy(mask), H)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    return [x.grad.numpy() for x in t]


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


def test_bwd_fully_masked_windows_follow_the_where_form():
    """A window whose keys are all masked: dq = dk = 0 and dv is the mean
    of g (the einsum VJP). The JAX chunked backward has no ``where`` on its
    dS, so there it sends gradient to dq and dk; it agrees on dv."""
    W, T, C, H = 4, 16, 32, 4
    q, k, v, mask, g = _bwd_inputs(W, T, C, seed=11, fully_masked=(0, 3))
    dq, dk, dv = (x.numpy() for x in wa.window_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, mask, g)), H))
    ref = _einsum_vjp(q, k, v, mask, g, H)
    chunked = [np.asarray(x) for x in xla_chunked_window_attention_bwd(
        *map(jnp.asarray, (q, k, v, mask, g)), H)]
    for w in (0, 3):
        assert not dq[w].any() and not dk[w].any()
        assert not ref[0][w].any() and not ref[1][w].any()
        np.testing.assert_allclose(
            dv[w], np.broadcast_to(g[w].mean(0), dv[w].shape), atol=1e-6)
        np.testing.assert_allclose(dv[w], chunked[2][w], atol=1e-6)
        assert np.abs(chunked[0][w]).max() > 1e-3


@pytest.mark.parametrize("chunk", [None, 1, 3])
def test_bwd_plain_matches_the_chunked_backward(chunk):
    """``xla_chunked_window_attention_bwd`` on the windows with a valid key
    (it differs from the einsum VJP in fully masked ones), one chunk and
    chunks smaller than W on both sides."""
    W, T, C, H = 11, 24, 32, 4
    q, k, v, mask, g = _bwd_inputs(W, T, C, seed=5, fully_masked=(2,))
    ref = [np.asarray(x) for x in xla_chunked_window_attention_bwd(
        *map(jnp.asarray, (q, k, v, mask, g)), H, chunk=chunk)]
    got = wa.window_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, mask, g)), H, chunk=chunk)
    live = mask.any(1)
    for r, o in zip(ref, got):
        np.testing.assert_allclose(o.numpy()[live], r[live], atol=1e-5,
                                   rtol=0)


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


def test_function_gradcheck_float64():
    """The Function's backward is the derivative of its forward (finite
    differences in float64, fully masked window included)."""
    q, k, v, mask = _inputs(3, 5, 8, seed=4, fully_masked=(1,))
    t = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    m = torch.from_numpy(mask)
    assert torch.autograd.gradcheck(
        lambda a, b, c: wa.window_attention(a, b, c, m, 2), t)


def test_bwd_plain_bf16_returns_bf16():
    q, k, v, mask, g = _bwd_inputs(3, 32, 128, seed=2)
    b = [torch.from_numpy(x).bfloat16() for x in (q, k, v, g)]
    m = torch.from_numpy(mask)
    got = wa.window_attention_bwd_plain(b[0], b[1], b[2], m, b[3], 8)
    ref = wa.window_attention_bwd_plain(*(x.float() for x in b[:3]), m,
                                        b[3].float(), 8)
    for o, r in zip(got, ref):
        assert o.dtype == torch.bfloat16
        # the only rounding is the final cast to bf16
        np.testing.assert_allclose(o.float().numpy(), r.numpy(),
                                   atol=1e-6, rtol=2 ** -8)


def test_function_on_cpu_counts_no_launch():
    q, k, v, mask, g = _bwd_inputs(2, 16, 32, seed=3)
    before = (dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES))
    _function_grads(q, k, v, mask, g, 4)
    assert (dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)) == before


def test_bwd_input_checks():
    q = torch.zeros(2, 16, 32)
    mask = torch.ones(2, 16, dtype=torch.bool)
    wa.check_bwd_inputs(q, q, q, mask, q.clone(), 4)
    with pytest.raises(ValueError):             # g of another dtype
        wa.check_bwd_inputs(q, q, q, mask, q.bfloat16(), 4)
    with pytest.raises(ValueError):             # g not contiguous
        wa.check_bwd_inputs(q, q, q, mask,
                            torch.zeros(2, 32, 16).transpose(1, 2), 4)
    big = torch.zeros(1, 300, 32)               # T above the backward's 256
    wa.check_inputs(big, big, big, torch.ones(1, 300, dtype=torch.bool), 4)
    with pytest.raises(ValueError):
        wa.check_bwd_inputs(big, big, big,
                            torch.ones(1, 300, dtype=torch.bool), big, 4)
    for W, T in ((3200, 32), (800, 144)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.zeros(W, T, 128, dtype=dt)
            wa.check_bwd_inputs(x, x, x, torch.ones(W, T, dtype=torch.bool),
                                x, 8)
