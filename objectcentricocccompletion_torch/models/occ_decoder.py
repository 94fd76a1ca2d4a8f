"""Implicit occupancy field decoder (counterpart of the JAX package's
``models/occ_decoder.py``).

A conditional MLP ``[LN(latent) ; nerf_posenc(query)] -> 512 -> 1024 ->
1024 -> 1 logit``. The first layer is split (``in_latent``, ``in_pos``):
the latent's product runs once per RoI and only the 60-wide encoding's
product runs per query (W [a; b] = W_a a + W_b b). A training forward
drops the first layer's and each hidden layer's activations (``dropout``).
Under sequence parallelism (``parallel/sp.py``) the queries are this
rank's slice of the query axis: the latent's product is replicated, and
everything from the encoding's product on runs in an SP region.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn

from ..parallel import sp
from .layers import (DropoutKeys, Mlp, activation, dense, dropout,
                     nerf_position_encoding, one_pass_ln)


class OccDecoder(nn.Module):
    def __init__(self, latent_dim: int,
                 mlp_dims: Sequence[int] = (512, 1024, 1024),
                 num_freqs: int = 10, act: str = "gelu",
                 pos_thresh: float = 0.5,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.num_freqs = num_freqs
        self.pos_thresh = pos_thresh
        self.dtype = dtype
        self.act = activation(act)
        c0 = mlp_dims[0]
        self.ln = nn.LayerNorm(latent_dim, eps=1e-5)
        self.in_latent = nn.Linear(latent_dim, c0, bias=False)
        self.in_pos = nn.Linear(2 * num_freqs * 3, c0, bias=False)
        self.in_norm = nn.LayerNorm(c0, eps=1e-3)
        self.mlp = Mlp(c0, tuple(mlp_dims[1:]) + (1,), is_head=True, act=act,
                       dtype=dtype, dropout=dropout)
        # the encoding's bound as a constant on the module's device (no
        # host-to-device copy per call)
        self.register_buffer("pos_bound", torch.tensor(
            (-8.0, -8.0, -4.0, 8.0, 8.0, 4.0)), persistent=False)

    def forward(self, latent: torch.Tensor, queries: torch.Tensor,
                keys: DropoutKeys | None = None) -> torch.Tensor:
        """latent [..., D], queries [..., K, 3] box-local -> float32
        occupancy logits [..., K]; ``keys``: the dropout keys of a training
        forward, or None. Under SP ``queries`` hold this rank's slice of
        the query axis (``sp.shard_seq``), and so do the logits."""
        latent = one_pass_ln(self.ln, latent)
        lat = dense(self.in_latent, latent, self.dtype)[..., None, :]
        with self.query_region(queries):
            pos = nerf_position_encoding(queries, self.num_freqs,
                                         self.pos_bound)
            x = sp.to_shards(lat) + dense(self.in_pos, pos, self.dtype)
            x = dropout(self.act(one_pass_ln(self.in_norm, x)), self.dropout,
                        keys)
            return self.mlp(x, keys)[..., 0].float()

    @staticmethod
    def query_region(queries: torch.Tensor):
        """The SP region of the query axis (``queries`` [..., K, 3] a
        rank's slice), or nothing while SP is unset."""
        n = sp.size()
        if n == 1:
            return contextlib.nullcontext()
        dim = queries.dim() - 2
        total = queries.shape[dim] * n
        return sp.region(dim, sp.seq_slice(total)[0], total)

    def classify(self, logits: torch.Tensor) -> torch.Tensor:
        return (torch.sigmoid(logits) > self.pos_thresh).to(torch.int32)
