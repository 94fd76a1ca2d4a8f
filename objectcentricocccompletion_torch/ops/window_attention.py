"""Masked multi-head window attention: the hand-written Hopper kernel, its
plain PyTorch version, and its launch count.

Counterpart of ``objectcentricocccompletion_tpu/ops/pallas_attention.py``:
the kernel (``csrc/window_attention.cu``) replaces the TPU kernel
``_attn_kernel`` launched by ``pallas_window_attention``, and
:func:`window_attention_plain` is the counterpart of
``jnp_window_attention``. Only the forward is ported.
"""
from __future__ import annotations

import collections

import torch

from . import _build

NEG = -1e9

# Launches of the CUDA kernel, by window capacity T. The wrapper adds one
# where it launches the kernel and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()

_HEAD_DIMS = (8, 16, 32)
_MAX_T = 512
_MAX_SMEM = 48 * 1024


def window_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mask: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """q/k/v [W, T, C], mask [W, T] bool -> [W, T, C] in q's dtype.

    Per head: ``softmax(where(mask, q.k / sqrt(hd), -1e9)) . v``, computed
    in float32 as the kernels (TPU and Hopper) compute it. A masked logit is
    replaced, not added to, so a fully masked window gives the mean of v."""
    W, T, C = q.shape
    hd = C // num_heads
    qh = q.float().reshape(W, T, num_heads, hd) * (1.0 / hd ** 0.5)
    kh = k.float().reshape(W, T, num_heads, hd)
    vh = v.float().reshape(W, T, num_heads, hd)
    logits = torch.einsum("wthd,wshd->whts", qh, kh)
    logits = torch.where(mask[:, None, None, :], logits, NEG)
    p = torch.softmax(logits, -1)
    out = torch.einsum("whts,wshd->wthd", p, vh)
    return out.reshape(W, T, C).to(q.dtype)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, num_heads: int) -> None:
    """Raise unless the CUDA kernel takes these inputs."""
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
    if not 1 <= T <= _MAX_T or (2 * hd + 1) * T * 4 > _MAX_SMEM:
        raise ValueError(f"window capacity T={T} outside the kernel's "
                         f"limits for head dim {hd}")


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """q/k/v [W, T, C], mask [W, T] bool -> [W, T, C].

    On CUDA tensors this launches the hand-written Hopper kernel
    (``csrc/window_attention.cu``), which replaces the TPU kernel
    ``pallas_attention.py::_attn_kernel``, or raises if the kernel does not
    take the inputs. On CPU tensors it runs :func:`window_attention_plain`.

    Bound on the H100: memory. The kernel reads q, k and v once and writes
    the output once, 4*W*T*C elements (104.9 MB at the bf16 small level
    W=3200, T=32, C=128; 118.0 MB at the large level W=800, T=144), 31.3 and
    35.2 us at 3.35 TB/s, against 1.7 and 8.6 us for its 4*W*T^2*C
    operations at the bf16 tensor-core peak. The design keeps every logit
    in registers: one block per (window, head) stages that head's K and V
    in shared memory and each thread runs an online softmax for one query.
    """
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_inputs(q, k, v, mask, num_heads)
    W, T, C = q.shape
    out = torch.empty_like(q)
    lib = _build.load("window_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), W, T, C, num_heads,
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"window_attention_fwd failed: CUDA error {err}")
    LAUNCHES[T] += 1
    return out
