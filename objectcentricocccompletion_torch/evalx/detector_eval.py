"""Detector prediction for evaluation (counterpart of the JAX package's
``evalx/detector_eval.py::make_predict_fn``; only the SST family so far).
"""
from __future__ import annotations

import torch


def make_predict_fn(model, family: str):
    """``(points, mask) -> (boxes [K, 7], scores [K], labels [K],
    valid [K])``, fixed output size, on the model's device. The model holds
    its own weights (the JAX version takes them as an argument)."""
    if family != "sst":
        raise ValueError(f"detector family {family!r} is not ported yet")

    @torch.inference_mode()
    def fn(points: torch.Tensor, mask: torch.Tensor):
        return model.predict(points, mask)

    return fn
