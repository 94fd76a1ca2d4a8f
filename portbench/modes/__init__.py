"""How each kind of traffic mix runs: one module per ``mode`` a mix names."""
from __future__ import annotations

import math

import torch


def port_config(fields: dict, dtype: str | None = None) -> dict:
    """A configuration file's fields as the port's dataclass takes them
    (lists as tuples), at ``dtype`` where the control asks for another
    compute dtype."""
    out = {k: tuple(v) if isinstance(v, list) else v
           for k, v in fields.items()}
    if dtype is not None:
        out["compute_dtype"] = dtype
    return out


def worst(acc: float, diff: torch.Tensor) -> float:
    """The larger of ``acc`` and the widest element of ``diff``; infinite
    where any element is not finite."""
    if diff.numel() == 0:
        return acc
    if not bool(torch.isfinite(diff).all()):
        return math.inf
    return max(acc, float(diff.abs().max()))
