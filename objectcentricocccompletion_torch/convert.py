"""Weight converter: a flax params tree of the JAX package's ``SSTDetector``,
``OcOccNetWithLoss``, ``DynamicCenterPoint``, ``FSD`` or ``TwoStageFSD``
to the port's ``state_dict``, and back.

The input is a nested dict of numpy arrays (``jax.device_get`` of the
params, or any tree read from disk); this module needs no JAX. Conversions:
Dense kernel ``[in, out]`` -> Linear weight ``[out, in]``; Conv kernel HWIO
-> OIHW; the kernel of a ``deblock{i}`` larger than 1x1 (SECONDFPN's
upsampling blocks, ``ConvTranspose`` with kernel = stride) HWIO -> torch's
``ConvTranspose2d`` ``[in, out, kh, kw]`` with its taps mirrored (flax
scatters tap (i, j) where torch scatters (kh-1-i, kw-1-j)); sparse-conv
kernels ``[K, Cin, Cout]`` (``kernel``, ``conv2_kernel``, ``down{i}_kernel``,
``conv_out_kernel``, and FSD's UNet's ``unet/down{i}``) stay as they
are, under their own names; LayerNorm /
GroupNorm ``scale`` -> ``weight``; ``bias`` stays. Module names:
``backbone/block{i}_shift{s}`` -> ``backbone.layers.{2i+s}``, ``dil{i}`` ->
``neck_convs.{i}``, and at the top level (SST's neck) ``GroupNorm_{i}`` ->
``neck_norms.{i}``; every other name (every OcOccNet and CenterPoint name
among them, CenterPoint's nested ``GroupNorm_{i}`` too, and every FSD
name) is the flax path joined with dots.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_RENAMES = (
    (re.compile(r"^block(\d+)_shift(\d)$"),
     lambda m: f"layers.{2 * int(m[1]) + int(m[2])}"),
    (re.compile(r"^dil(\d+)$"), lambda m: f"neck_convs.{m[1]}"),
)
# the top level only: SST's neck norms (CenterPoint's sit deeper)
_TOP_RENAMES = _RENAMES + (
    (re.compile(r"^GroupNorm_(\d+)$"), lambda m: f"neck_norms.{m[1]}"),
)
_DEBLOCK = re.compile(r"^deblock\d+$")
# FSD's UNet holds its strided kernels as bare parameters
_UNET_DOWN = re.compile(r"^down\d+$")
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


def _transposed(mods, spatial) -> bool:
    """A SECONDFPN upsampling block: ``deblock{i}`` with a kernel larger
    than 1x1 (its stride-1 blocks are 1x1 convolutions)."""
    return bool(mods) and bool(_DEBLOCK.match(mods[-1])) \
        and spatial[0] * spatial[1] > 1


def flax_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) -> the port's state_dict (float32
    CPU tensors)."""
    out = {}
    for path, leaf in _flatten(params):
        a = np.asarray(leaf, np.float32)
        *mods, name = path
        key = ".".join(_rename(m, _TOP_RENAMES if i == 0 else _RENAMES)
                       for i, m in enumerate(mods))
        if (name == "kernel" or name.endswith("_kernel")
                or (mods and mods[-1] == "unet" and _UNET_DOWN.match(name))) \
                and a.ndim == 3:
            pass                      # sparse-conv kernel [K, Cin, Cout]
        elif name == "kernel":
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 4 and _transposed(mods, a.shape[:2]):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
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


def flax_leaf(key: str, shape) -> tuple[tuple[str, ...], tuple[int, ...],
                                      bool]:
    """Where a state_dict entry of ``shape`` lies in the flax tree: its
    path, the permutation ``perm`` with flax dim ``i`` = torch dim
    ``perm[i]``, and whether the taps are mirrored (``ConvTranspose``)."""
    mods = re.sub(r"(layers|neck_convs|neck_norms)\.(\d+)", r"\1@\2",
                  key).split(".")
    *mods, name = [m.replace("@", ".") for m in mods]
    mods = [_rename(m, _INVERSE) for m in mods]
    nd = len(shape)
    perm, mirrored = tuple(range(nd)), False
    if name == "weight" and nd == 2:
        perm, name = (1, 0), "kernel"
    elif name == "weight" and nd == 4 and _transposed(mods, shape[2:]):
        perm, name, mirrored = (2, 3, 0, 1), "kernel", True
    elif name == "weight" and nd == 4:
        perm, name = (2, 3, 1, 0), "kernel"
    elif name == "weight":
        name = "scale"
    return tuple(mods) + (name,), perm, mirrored


def state_dict_to_flax(state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`flax_to_state_dict`: a state_dict (parameters
    only) -> nested flax params with numpy leaves."""
    tree: dict = {}
    for key, t in state_dict.items():
        a = t.detach().cpu().float().numpy()
        (*mods, name), perm, mirrored = flax_leaf(key, a.shape)
        a = a.transpose(perm)
        if mirrored:
            a = a[::-1, ::-1]
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return tree
