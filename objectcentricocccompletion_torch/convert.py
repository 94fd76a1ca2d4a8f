"""Weight converter: a flax params tree of the JAX package's ``SSTDetector``
or ``OcOccNetWithLoss`` to the port's ``state_dict``, and back.

The input is a nested dict of numpy arrays (``jax.device_get`` of the
params, or any tree read from disk); this module needs no JAX. Conversions:
Dense kernel ``[in, out]`` -> Linear weight ``[out, in]``; Conv kernel HWIO
-> OIHW; LayerNorm / GroupNorm ``scale`` -> ``weight``; ``bias`` stays.
Module names: ``backbone/block{i}_shift{s}`` -> ``backbone.layers.{2i+s}``,
``dil{i}`` -> ``neck_convs.{i}``, ``GroupNorm_{i}`` -> ``neck_norms.{i}``;
every other name (every OcOccNet name among them) is the flax path joined
with dots.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_RENAMES = (
    (re.compile(r"^block(\d+)_shift(\d)$"),
     lambda m: f"layers.{2 * int(m[1]) + int(m[2])}"),
    (re.compile(r"^dil(\d+)$"), lambda m: f"neck_convs.{m[1]}"),
    (re.compile(r"^GroupNorm_(\d+)$"), lambda m: f"neck_norms.{m[1]}"),
)
_INVERSE = (
    (re.compile(r"^layers\.(\d+)$"),
     lambda m: f"block{int(m[1]) // 2}_shift{int(m[1]) % 2}"),
    (re.compile(r"^neck_convs\.(\d+)$"), lambda m: f"dil{m[1]}"),
    (re.compile(r"^neck_norms\.(\d+)$"), lambda m: f"GroupNorm_{m[1]}"),
)


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rename(name: str, rules) -> str:
    for pat, fn in rules:
        m = pat.match(name)
        if m:
            return fn(m)
    return name


def flax_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) -> the port's state_dict (float32
    CPU tensors)."""
    out = {}
    for path, leaf in _flatten(params):
        a = np.asarray(leaf, np.float32)
        *mods, name = path
        key = ".".join(_rename(m, _RENAMES) for m in mods)
        if name == "kernel":
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"kernel of rank {a.ndim} at {path}")
            name = "weight"
        elif name == "scale":
            name = "weight"
        elif name != "bias":
            raise ValueError(f"unknown parameter {path}")
        out[f"{key}.{name}"] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def state_dict_to_flax(state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`flax_to_state_dict`: a state_dict (parameters
    only) -> nested flax params with numpy leaves."""
    tree: dict = {}
    for key, t in state_dict.items():
        a = t.detach().cpu().float().numpy()
        mods = re.sub(r"(layers|neck_convs|neck_norms)\.(\d+)", r"\1@\2",
                      key).split(".")
        *mods, name = [m.replace("@", ".") for m in mods]
        mods = [_rename(m, _INVERSE) for m in mods]
        if name == "weight" and a.ndim == 2:
            a, name = a.T, "kernel"
        elif name == "weight" and a.ndim == 4:
            a, name = a.transpose(2, 3, 1, 0), "kernel"
        elif name == "weight":
            name = "scale"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return tree
