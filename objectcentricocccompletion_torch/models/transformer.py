"""Causal temporal transformer over a tracklet's frames (counterpart of the
JAX package's ``models/transformer.py``).

Post-norm layers as torch's: q = k = src + pos, v = src; src += attn; LN;
src += FFN; LN (eps 1e-5). Attention is three products with an additive
causal mask (optionally restricted to the last ``window`` frames); the
softmax runs in float32, and a training forward drops attention weights
after it (``attn_dropout``). The JAX package computes it with XLA einsums, not
a Pallas kernel, and so does this module with PyTorch's.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import DropoutKeys, activation, dense, dropout, one_pass_ln


class CausalSelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_dropout = attn_dropout
        for name in ("q", "k", "v", "out"):
            self.add_module(name, nn.Linear(d_model, d_model))

    def forward(self, q_in, k_in, v_in, mask, keys=None):
        """q_in / k_in / v_in [B, L, D]; mask [L, L] additive (0 / -inf)."""
        d = v_in.shape[-1]
        h = self.num_heads
        hd = d // h
        # 1 / sqrt(hd) in float32, a weakly typed scalar in the JAX package:
        # q keeps the computation dtype
        scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))

        def split(x, layer):
            y = dense(layer, x, self.dtype)
            return y.reshape(y.shape[:-1] + (h, hd))

        q = split(q_in, self.q) * scale
        k = split(k_in, self.k)
        v = split(v_in, self.v)
        logits = torch.einsum("blhd,bmhd->bhlm", q, k).float() + mask.float()
        w = torch.softmax(logits, -1).to(self.dtype)
        w = dropout(w, self.attn_dropout, keys)
        out = torch.einsum("bhlm,bmhd->blhd", w, v)
        return dense(self.out, out.reshape(out.shape[:-2] + (d,)),
                     self.dtype)


class TemporalEncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int = 4, ffn_dim: int = 512,
                 act: str = "gelu", dtype: torch.dtype = torch.float32,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.act = activation(act)
        self.self_attn = CausalSelfAttention(d_model, num_heads, dtype,
                                             attn_dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, mask, keys=None):
        qk = src + pos
        src = one_pass_ln(self.norm1,
                          src + self.self_attn(qk, qk, src, mask, keys))
        ffn = self.act(dense(self.linear1, src, self.dtype))
        ffn = dense(self.linear2, ffn, self.dtype)
        return one_pass_ln(self.norm2, src + ffn)


def attention_mask(L: int, causal: bool = True, window: int = -1,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """[L, L] additive mask: 0 where frame i may attend to frame j, -inf
    elsewhere; ``window`` > 0 keeps only the last ``window`` frames."""
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    allowed = torch.ones(L, L, dtype=torch.bool, device=device)
    if causal:
        allowed &= j <= i
    if window > 0:
        allowed &= j > i - window
    return torch.where(allowed, 0.0, float("-inf")).to(dtype)


class TemporalEncoder(nn.Module):
    def __init__(self, d_model: int, num_layers: int = 3, num_heads: int = 4,
                 ffn_dim: int = 512, dtype: torch.dtype = torch.float32,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        for n in range(num_layers):
            self.add_module(f"layer_{n}", TemporalEncoderLayer(
                d_model, num_heads, ffn_dim, dtype=dtype,
                attn_dropout=attn_dropout))

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                causal: bool = True, window: int = -1,
                keys: DropoutKeys | None = None) -> torch.Tensor:
        """src, pos [B, L, D]; ``window`` > 0 also restricts attention to
        the last ``window`` frames (the test-time attention window);
        ``keys``: the dropout keys of a training forward, or None."""
        mask = attention_mask(src.shape[1], causal, window, src.dtype,
                              src.device)
        for n in range(self.num_layers):
            src = getattr(self, f"layer_{n}")(src, pos, mask, keys)
        return src
