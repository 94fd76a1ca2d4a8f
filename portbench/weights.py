"""Seeded weights, drawn on the device in one call.

A reference's ``param_specs(cfg)`` lists every parameter as ``(name, shape,
kind, fan_in)`` under the port's state-dict names: ``"w"`` is a Dense or
convolution weight, drawn normal with variance ``1 / fan_in``; ``"ones"``
(norm scales) and ``"zeros"`` (biases and norm shifts) are constants. The
same state dict goes into the port's model (``load_state_dict(strict=
True)``, which also checks that both sides name the same parameters) and
into the reference.
"""
from __future__ import annotations

import math

import torch

from .traffic import generator


def draw(specs: list, seed: int, device) -> dict:
    """name -> float32 tensor on ``device``; every ``"w"`` from one draw of
    standard normals."""
    sizes = [math.prod(shape) for _, shape, kind, _ in specs if kind == "w"]
    buf = torch.randn(sum(sizes), generator=generator(seed, 0, device),
                      device=device)
    out, off = {}, 0
    for name, shape, kind, fan_in in specs:
        if kind == "w":
            n = math.prod(shape)
            out[name] = buf[off:off + n].view(shape) * (1.0 / fan_in ** 0.5)
            off += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
    return out
