"""Masked multi-head window attention: the hand-written Hopper kernels
(forward and backward), their plain PyTorch versions, and their launch
counts.

Counterpart of ``objectcentricocccompletion_tpu/ops/pallas_attention.py``:

- the forward kernels replace the TPU kernel ``_attn_kernel`` launched by
  ``pallas_window_attention``: ``csrc/window_attention_tc.cu`` (bfloat16)
  and ``csrc/window_attention.cu`` (float32, in 3xTF32), both on the tensor
  cores;
  :func:`window_attention_plain` is the counterpart of
  ``jnp_window_attention``;
- the backward kernels replace the TPU kernels ``_attn_bwd_kernel`` and
  ``_attn_bwd_kernel_fullstore`` of ``benchmarks/repro_attn_bwd.py``:
  ``csrc/window_attention_bwd_tc.cu`` (bfloat16) and
  ``csrc/window_attention_bwd.cu`` (float32, in 3xTF32);
  :func:`window_attention_bwd_plain` is the counterpart of
  ``xla_chunked_window_attention_bwd``;
- :func:`window_attention` is differentiable on both devices, as
  ``pallas_window_attention``'s ``custom_vjp`` is.

The gradients are those of the ``where`` form of the mask (a masked logit
is replaced by -1e9): no gradient reaches q or k in a window whose keys are
all masked.
"""
from __future__ import annotations

import torch

from ..utils import profiling
from . import _build

NEG = -1e9

# Launches of the CUDA kernels, by window capacity T: the forward's and the
# backward's (either dtype's kernel), tallies of ``utils/profiling.py``. Each
# wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = profiling.TALLIES["window_attention.launches"]
BWD_LAUNCHES = profiling.TALLIES["window_attention.bwd_launches"]

_HEAD_DIMS = (8, 16, 32)
# window capacities the kernels take, both dtypes. A block stages q, k and v
# (the backward also g) of at least one head in shared memory; at these
# limits and hd = 32 that is at most 218 KB (float32 forward) and 147 KB
# (float32 backward), within the 227 KB a block may use on the H100
_MAX_T = 512
_BWD_MAX_T = 256
# target live [chunk, H, T, T] float32 footprint of the plain backward (the
# JAX package's CHUNK_BYTES)
CHUNK_BYTES = 256 << 20


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 arithmetic, as the kernels do; float64 stays float64 (for
    gradient checks by finite differences)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def window_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mask: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """q/k/v [W, T, C], mask [W, T] bool -> [W, T, C] in q's dtype.

    Per head: ``softmax(where(mask, q.k / sqrt(hd), -1e9)) . v``, computed
    in float32 as the kernels (TPU and Hopper) compute it (float64 inputs in
    float64). A masked logit is replaced, not added to, so a fully masked
    window gives the mean of v."""
    W, T, C = q.shape
    hd = C // num_heads
    acc = _acc_dtype(q.dtype)
    qh = q.to(acc).reshape(W, T, num_heads, hd) * (1.0 / hd ** 0.5)
    kh = k.to(acc).reshape(W, T, num_heads, hd)
    vh = v.to(acc).reshape(W, T, num_heads, hd)
    logits = torch.einsum("wthd,wshd->whts", qh, kh)
    logits = torch.where(mask[:, None, None, :], logits, NEG)
    p = torch.softmax(logits, -1)
    out = torch.einsum("whts,wshd->wthd", p, vh)
    return out.reshape(W, T, C).to(q.dtype)


def window_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, mask: torch.Tensor,
                               g: torch.Tensor, num_heads: int,
                               chunk: int | None = None):
    """The gradients (dq, dk, dv) [W, T, C] of :func:`window_attention_plain`
    for the output gradient ``g`` [W, T, C], in q's dtype.

    The softmax is recomputed in float32 (float64 inputs in float64), one
    chunk of windows at a time so that the live [chunk, H, T, T] tensors
    stay near ``CHUNK_BYTES``, as ``xla_chunked_window_attention_bwd``
    chunks them (``chunk`` overrides the count). The masked logits are
    replaced, so they pass no gradient: a fully masked window gets
    dq = dk = 0 and dv_s = mean_t g_t."""
    W, T, C = q.shape
    hd = C // num_heads
    scale = 1.0 / hd ** 0.5
    acc = _acc_dtype(q.dtype)
    if chunk is None:
        chunk = max(min(W, CHUNK_BYTES // max(num_heads * T * T * 4, 1)), 1)

    def block(qb, kb, vb, mb, gb):
        n = qb.shape[0]
        qh, kh, vh, gh = (x.to(acc).reshape(n, T, num_heads, hd)
                          for x in (qb, kb, vb, gb))
        qh = qh * scale
        logits = torch.einsum("wthd,wshd->whts", qh, kh)
        logits = torch.where(mb[:, None, None, :], logits, NEG)
        p = torch.softmax(logits, -1)
        dv = torch.einsum("whts,wthd->wshd", p, gh)
        dp = torch.einsum("wthd,wshd->whts", gh, vh)
        delta = (p * dp).sum(-1, keepdim=True)
        ds = torch.where(mb[:, None, None, :], p * (dp - delta), 0.0)
        dq = torch.einsum("whts,wshd->wthd", ds, kh) * scale
        dk = torch.einsum("whts,wthd->wshd", ds, qh)
        return tuple(x.reshape(n, T, C).to(q.dtype) for x in (dq, dk, dv))

    parts = [block(q[b:b + chunk], k[b:b + chunk], v[b:b + chunk],
                   mask[b:b + chunk], g[b:b + chunk])
             for b in range(0, W, chunk)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[i] for p in parts], 0) for i in range(3))


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, num_heads: int) -> None:
    """Raise unless the forward CUDA kernel takes these inputs."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [W, T, C] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    W, T, C = q.shape
    if mask.shape != (W, T) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [{W}, {T}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v, mask)):
        raise ValueError("q, k, v and mask must lie on one device")
    if any(not t.is_contiguous() for t in (q, k, v, mask)):
        raise ValueError("q, k, v and mask must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    if num_heads <= 0 or C % num_heads:
        raise ValueError(f"C={C} is not a multiple of num_heads="
                         f"{num_heads}")
    hd = C // num_heads
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_HEAD_DIMS}")
    if not 1 <= T <= _MAX_T:
        raise ValueError(f"window capacity T={T} outside the kernel's "
                         f"limit {_MAX_T}")


def check_bwd_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, g: torch.Tensor,
                     num_heads: int) -> None:
    """Raise unless the backward CUDA kernel takes these inputs: those of
    the forward, ``g`` like q, and the backward's own limits on T."""
    check_inputs(q, k, v, mask, num_heads)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must match q: got {g.dtype} {tuple(g.shape)} "
                         f"on {g.device}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("g must be contiguous and 16-byte aligned")
    T = q.shape[1]
    if T > _BWD_MAX_T:
        raise ValueError(f"window capacity T={T} outside the backward "
                         f"kernel's limit {_BWD_MAX_T}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _fwd_kernel(q, k, v, mask, num_heads):
    check_inputs(q, k, v, mask, num_heads)
    W, T, C = q.shape
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        fn = _build.load("window_attention_tc").window_attention_tc_fwd
    else:
        fn = _build.load("window_attention").window_attention_fwd
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), W, T, C, num_heads, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    profiling.tally("window_attention.launches", T)
    return out


def _bwd_kernel(q, k, v, mask, g, num_heads):
    check_bwd_inputs(q, k, v, mask, g, num_heads)
    W, T, C = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.dtype == torch.bfloat16:
        fn = _build.load("window_attention_bwd_tc").window_attention_tc_bwd
    else:
        fn = _build.load("window_attention_bwd").window_attention_bwd
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                 g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 W, T, C, num_heads, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    profiling.tally("window_attention.bwd_launches", T)
    return dq, dk, dv


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


class WindowAttention(torch.autograd.Function):
    """Window attention with the kernels' gradient. On CUDA tensors the
    forward and the backward each launch their kernel or raise; on CPU
    tensors they run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, mask, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, mask)
        if not _on_cuda(q):
            return window_attention_plain(q, k, v, mask, num_heads)
        if any(ctx.needs_input_grad[:3]):
            # fail at the forward, not in the middle of the backward
            check_bwd_inputs(q, k, v, mask, q, num_heads)
        return _fwd_kernel(q, k, v, mask, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        g = g.contiguous()
        if _on_cuda(q):
            dq, dk, dv = _bwd_kernel(q, k, v, mask, g, ctx.num_heads)
        else:
            dq, dk, dv = window_attention_bwd_plain(q, k, v, mask, g,
                                                    ctx.num_heads)
        return dq, dk, dv, None, None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """q/k/v [W, T, C], mask [W, T] bool -> [W, T, C], differentiable in
    q, k and v.

    On CUDA tensors the forward and the backward each launch a hand-written
    Hopper tensor-core kernel, and raise if it does not take the inputs:
    bfloat16 goes to ``csrc/window_attention_tc.cu`` and
    ``csrc/window_attention_bwd_tc.cu``, float32 (SST's default compute
    dtype) to ``csrc/window_attention.cu`` and
    ``csrc/window_attention_bwd.cu``, whose products run as three TF32
    products each (3xTF32) to keep float32's accuracy. They
    replace the TPU kernels ``pallas_attention.py::_attn_kernel`` and
    ``repro_attn_bwd.py::_attn_bwd_kernel`` / ``_attn_bwd_kernel_fullstore``.
    On CPU tensors they run :func:`window_attention_plain` and
    :func:`window_attention_bwd_plain`.

    Bound on the H100, bf16 forward: bytes and exponentials about equally.
    It must read v and write the output for every window and read q and k
    for windows with a valid key, at most 4*W*T*C elements (118.0 MB at the
    large level W=800, T=144, C=128: 35.2 us at 3.35 TB/s), and take one
    exponential per (query, key, head) (132.7 M there: 32 us at 16 ex2 per
    clock and SM); its products take 8.6 us at the bf16 tensor-core peak.
    float32 forward: bytes, 235.9 MB there (70.4 us); its products take
    51 us in 3xTF32 at 494.7 / 3 TFLOP/s. Each source's note gives its
    bound and design.
    """
    return WindowAttention.apply(q, k, v, mask, num_heads)
