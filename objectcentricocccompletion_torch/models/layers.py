"""Shared building blocks (counterpart of the JAX package's
``models/layers.py``, the parts the SST and OcOccNet paths use), with the
JAX package's counter-hash dropout."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.routes import relu

LN_EPS = 1e-3

_INV_SQRT2 = 0.7071067811865476


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The exact erf GELU (torch's ``nn.GELU()`` default, not the tanh
    form), written out as the JAX package writes it."""
    return x * 0.5 * (1.0 + torch.erf(x * _INV_SQRT2))


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """A flax ``Dense(dtype=...)``: input, weight and bias are cast to the
    computation dtype (parameters stay float32 in the module); ``None``
    keeps the input's dtype."""
    dt = dtype or x.dtype
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def conv(layer: nn.Conv2d, x: torch.Tensor,
         dtype: torch.dtype | None = None) -> torch.Tensor:
    """A flax ``Conv(dtype=...)`` on an NCHW map, with the layer's own
    padding and dilation."""
    dt = dtype or x.dtype
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.conv2d(x.to(dt), layer.weight.to(dt), bias, layer.stride,
                    layer.padding, layer.dilation)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A flax ``LayerNorm`` with float32 parameters: statistics in float32,
    and the result is float32 whatever the input dtype."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps)


def layer_norm_one_pass(layer: nn.LayerNorm, x: torch.Tensor
                        ) -> torch.Tensor:
    """flax's ``LayerNorm`` arithmetic, step for step: the variance in one
    pass as ``max(E[x^2] - E[x]^2, 0)``, in float32, differentiated by
    autograd through that formula. Where the inputs' mean across channels is
    large next to their spread (the VFE's first layer reads raw
    coordinates), its gradient and that of :func:`layer_norm` differ in
    float32 by more than 1e-4; this form keeps the JAX package's."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean.square()).clamp(min=0)
    mul = torch.rsqrt(var + layer.eps) * layer.weight
    return (x - mean) * mul + layer.bias


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's default kernel init (variance 1/fan_in, truncated at 2 std)."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def he_normal_(p: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``he_normal`` for a ``[K, Cin, Cout]`` sparse-conv kernel:
    truncated normal of variance 2 / (K * Cin)."""
    std = (2.0 / (p.shape[0] * p.shape[1])) ** 0.5 / 0.87962566103423978
    w = torch.empty(p.shape)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    with torch.no_grad():
        p.copy_(w)


def init_flax_like_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every Linear and Conv2d weight of ``module`` as flax
    would (lecun normal, biases zero) from ``generator``; norms get ones and
    zeros. Parameters are drawn on the CPU, in module order."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            w = torch.empty(m.weight.shape)
            lecun_normal_(w, fan_in, generator)
            with torch.no_grad():
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()


def one_pass_ln(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``OnePassLayerNorm``: float32 statistics in one
    pass, the result cast back to the input's dtype."""
    return layer_norm_one_pass(layer, x).to(x.dtype)


def gelu_auto(x: torch.Tensor) -> torch.Tensor:
    """The dtype-adaptive GELU: the exact erf form in float32, the tanh
    form in bfloat16 (``models/layers.py::_gelu_auto`` of the JAX
    package)."""
    if x.dtype in (torch.float32, torch.float64):
        return F.gelu(x)
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"gelu": gelu_auto, "relu": relu,
            "leakyrelu": F.leaky_relu}[name]


_U32 = 0xFFFFFFFF


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c`` modulo 2^32 for uint32 values held in int64, in two 16-bit
    halves of ``c`` so that no product overflows int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_bits(key: torch.Tensor, shape: Sequence[int],
              offset: int = 0) -> torch.Tensor:
    """The JAX package's ``_hash_bits``, bit for bit: a murmur3 finalizer
    over the counter ``offset + iota(prod(shape))``, keyed by the two
    uint32 words of ``key`` (an int64 tensor ``[2]``). The uint32
    arithmetic runs in int64 and is masked to 32 bits; returns int64
    values in [0, 2^32) of ``shape``, on ``key``'s device."""
    n = math.prod(shape)
    k0, k1 = key[0], key[-1]
    h = torch.arange(offset, offset + n, dtype=torch.int64,
                     device=key.device)
    h = (_mul_u32(h, 2654435761) + k0) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h ^ k1
    h = _mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h.reshape(tuple(shape))


class DropoutKeys:
    """The key words of every dropout site in one training forward, handed
    out in call order (``keys()`` -> an int64 ``[2]`` tensor).

    ``DropoutKeys(base)``: site ``i`` gets ``hash_bits(base, (2,), 2 * i)``,
    derived on ``base``'s device with no host synchronisation; the train
    step passes ``base`` = [seed, step] as a device tensor. ``DropoutKeys(
    words=[...])`` hands out the given words instead (the tests pass the
    JAX package's, which flax derives from the module path; the port does
    not rebuild that stream)."""

    def __init__(self, base: torch.Tensor | None = None,
                 words: Sequence[torch.Tensor] | None = None):
        if (base is None) == (words is None):
            raise ValueError("give exactly one of base and words")
        self.base, self.words = base, words
        self.site = 0

    def __call__(self) -> torch.Tensor:
        i = self.site
        self.site += 1
        if self.words is not None:
            return self.words[i]
        return hash_bits(self.base, (2,), 2 * i)


def dropout(x: torch.Tensor, rate: float, keys: DropoutKeys | None
            ) -> torch.Tensor:
    """The JAX package's ``BarrierDropout``: keep where the hash bits are
    below ``min(round(keep * 2^32), 2^32 - 1)``, and scale the kept values
    by ``1 / keep`` rounded to float32 and then cast to ``x``'s dtype
    before the multiply (1/0.9 is 1.109375 in bf16). ``keys`` None (not
    training) or ``rate`` 0 leave ``x`` as it is."""
    if keys is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    bits = hash_bits(keys(), x.shape)
    thresh = min(int(round(keep * 4294967296.0)), _U32)
    # a host number, exact in x's dtype: no copy to the device
    scale = float(torch.tensor(1.0 / keep, dtype=torch.float32).to(x.dtype))
    return x * torch.where(bits < thresh, scale, 0.0).to(x.dtype)


class Mlp(nn.Module):
    """``Mlp`` of the JAX package: hidden layers are Dense (no bias) ->
    one-pass LayerNorm (epsilon ``ln_eps``) -> act -> dropout; with
    ``is_head`` the last layer is a biased Dense. Dense layers run in
    ``dtype``; parameters stay float32. Module names are the flax ones
    (``Dense_{i}``, ``LayerNorm_{i}``)."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 is_head: bool = False, act: str = "gelu",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 ln_eps: float = LN_EPS):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.act = activation(act)
        self.num_layers = len(hidden_dims)
        self.is_head = is_head
        fin = in_dim
        for i, c in enumerate(hidden_dims):
            last_head = is_head and i == self.num_layers - 1
            self.add_module(f"Dense_{i}", nn.Linear(fin, c, bias=last_head))
            if not last_head:
                self.add_module(f"LayerNorm_{i}", nn.LayerNorm(c, eps=ln_eps))
            fin = c

    def forward(self, x: torch.Tensor, keys: DropoutKeys | None = None
                ) -> torch.Tensor:
        """``keys``: the dropout keys of a training forward, or None."""
        x = x.to(self.dtype)
        for i in range(self.num_layers):
            x = dense(getattr(self, f"Dense_{i}"), x, self.dtype)
            if not (self.is_head and i == self.num_layers - 1):
                x = self.act(one_pass_ln(getattr(self, f"LayerNorm_{i}"), x))
                x = dropout(x, self.dropout, keys)
        return x


class VfeLayer(nn.Module):
    """``VfeLayer`` of the JAX package: dropout -> Dense (no bias) ->
    one-pass LayerNorm -> act, in ``dtype``."""

    def __init__(self, in_dim: int, out_channels: int, act: str = "gelu",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.act = activation(act)
        self.Dense_0 = nn.Linear(in_dim, out_channels, bias=False)
        self.LayerNorm_0 = nn.LayerNorm(out_channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor, keys: DropoutKeys | None = None
                ) -> torch.Tensor:
        x = dropout(x, self.dropout, keys)
        x = one_pass_ln(self.LayerNorm_0, dense(self.Dense_0, x, self.dtype))
        return self.act(x).to(self.dtype)


def sinusoidal_position_encoding(positions: torch.Tensor, d_model: int
                                 ) -> torch.Tensor:
    """Frame-index encoding: [sin(p * div), cos(p * div)], the halves
    concatenated (not interleaved); float32."""
    dev = positions.device
    # -log(10000) / d_model in float32 arithmetic, as jnp computes it
    step = -np.log(np.float32(10000.0)) / np.float32(d_model)
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=dev) * float(step))
    ang = positions[..., None].float() * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def nerf_position_encoding(xyz: torch.Tensor, num_freqs: int = 10,
                           bound=(-8.0, -8.0, -4.0, 8.0, 8.0, 4.0)
                           ) -> torch.Tensor:
    """Query-point encoding: normalise to [-1, 1] by ``bound`` (6 values,
    or a tensor of them on the queries' device), then sin(pi x 2^k) and
    cos(pi x 2^k), concatenated on the frequency axis and flattened over
    (frequency, xyz) to ``2 * num_freqs * 3`` channels."""
    b = torch.as_tensor(bound, dtype=xyz.dtype, device=xyz.device)
    lo, hi = b[:3], b[3:]
    x = (xyz - lo) / (hi - lo) * 2.0 - 1.0
    freqs = 2.0 ** torch.arange(num_freqs, dtype=xyz.dtype,
                                device=xyz.device)
    # the angles in the JAX order, (pi * x) * 2^k: they reach 512 pi
    ang = (math.pi * x)[..., None, :] * freqs[:, None]      # [..., F, 3]
    out = torch.cat([torch.sin(ang), torch.cos(ang)], -2)
    return out.reshape(out.shape[:-2] + (2 * num_freqs * 3,))
