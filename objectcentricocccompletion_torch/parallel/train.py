"""The OcOccNet training step (counterpart of the JAX package's
``parallel/train.py``: ``create_train_state`` and the single-device body of
``make_train_step`` with the tree optimizer).

One device and no mesh: the port has no data, tensor or sequence
parallelism yet, and no flat or stacked optimizer (the JAX package's ways
around the TPU's launch overhead). A step runs the loss, the backward, the
gradients' global norm (before the clip, as ``optax.global_norm(grads)``),
the clip at ``cfg.grad_clip_norm`` and AdamW at ``schedule(step)``, step
counted from 0. The parameters stay float32; ``cfg.compute_dtype`` sets
the compute dtype. Dropout draws its keys on the device from ``[seed,
step]``, so a step reads nothing back to the host.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.ococcnet_config import OcOccNetConfig
from ..data.tracklet import TrackletBatch
from ..models.layers import DropoutKeys
from ..models.ococcnet import OcOccNetWithLoss
from ..training.optim import (clip_grad_global_norm_, global_norm,
                              make_optimizer, set_lr)


def frozen_prefixes(cfg: OcOccNetConfig) -> tuple:
    """Parameter names that take no update: the occupancy auto-encoder
    under ``fixed_ae`` (the reference's frozen-AE mode)."""
    return ("ae_encoder",) if cfg.fixed_ae else ()


def create_train_state(cfg: OcOccNetConfig, total_steps: int,
                       device="cuda", seed: int = 0):
    """``(model, optimizer, schedule)``: ``OcOccNetWithLoss`` with weights
    drawn from a ``torch.Generator`` seeded with ``seed``, on ``device``
    (``cuda`` unless the caller asks for the CPU), and AdamW with the
    cyclic-cosine schedule of the config's recipe."""
    model = OcOccNetWithLoss(cfg, device,
                             torch.Generator().manual_seed(seed))
    optimizer, schedule = make_optimizer(
        model.named_parameters(), cfg.base_lr, total_steps,
        weight_decay=cfg.weight_decay, peak_ratio=cfg.lr_mult,
        frozen_prefixes=frozen_prefixes(cfg))
    return model, optimizer, schedule


def make_train_step(model: OcOccNetWithLoss,
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], seed: int = 0):
    """``step_fn(step, batch) -> metrics``: one training step on ``batch``
    (moved to the model's device). The metrics are the loss dict and
    ``grad_norm``, 0-d tensors on the device (reading them synchronises).
    Under ``fixed_ae`` the clip, as in the JAX package, sees the trained
    parameters' gradients only, and ``grad_norm`` all of them."""
    cfg = model.cfg
    device = model.code_weights.device
    trained = [p for group in optimizer.param_groups
               for p in group["params"]]
    params = list(model.parameters())
    frozen = len(trained) != len(params)
    # [seed, step]: the dropout keys' base, updated in place on the device
    base = torch.tensor([seed, 0], dtype=torch.int64, device=device)

    def step_fn(step: int, batch: TrackletBatch) -> dict:
        batch = batch.to(device)
        base[1].fill_(step)
        set_lr(optimizer, schedule(step))
        model.zero_grad(set_to_none=True)
        total, aux = model(batch, train=True, keys=DropoutKeys(base))
        total.backward()
        every = (global_norm(p.grad for p in params if p.grad is not None)
                 if frozen else None)
        norm = clip_grad_global_norm_(trained, cfg.grad_clip_norm)
        optimizer.step()
        return {**{k: v.detach() for k, v in aux.items()},
                "grad_norm": norm if every is None else every}

    return step_fn
