"""Shared building blocks (counterpart of the JAX package's
``models/layers.py``, only the parts the SST path uses)."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

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
