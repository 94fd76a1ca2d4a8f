"""Masked dense reductions (counterpart of the JAX package's
``ops/masked.py::masked_max`` / ``masked_mean``): groups are laid out
densely as ``[..., item, channel]`` with a validity mask."""
from __future__ import annotations

import torch

_NEG = -1e30


def _expand(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a [..., items] mask against x [..., items, channels]."""
    return mask[..., None] if mask.dim() == x.dim() - 1 else mask


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int
               ) -> torch.Tensor:
    """Max over ``dim`` of the ``mask``-true items; 0 for an empty group."""
    m = _expand(mask, x)
    out = torch.where(m, x, _NEG).amax(dim)
    return torch.where(m.any(dim), out, 0.0)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int
                ) -> torch.Tensor:
    """Mean over ``dim`` of the ``mask``-true items; 0 for an empty group."""
    m = _expand(mask, x)
    s = torch.where(m, x, 0.0).sum(dim)
    n = m.sum(dim)
    return s / n.clamp(min=1)
