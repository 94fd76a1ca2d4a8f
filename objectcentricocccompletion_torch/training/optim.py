"""Optimizer and learning-rate schedule (counterpart of the JAX package's
``training/optim.py::cyclic_cosine_schedule``, ``_no_decay_mask`` and
``make_optimizer``).

The reference recipe: AdamW(0.9, 0.999, eps 1e-8), weight decay 0.05 on
every parameter but norms and biases, global-norm gradient clip 10, and
mmcv's one-cycle "cyclic" schedule (cosine ramp from base_lr to 100x over
the first 10% of steps, then cosine anneal to 100x * 1e-3 * base_lr).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def cyclic_cosine_schedule(base_lr: float, total_steps: int,
                           peak_ratio: float = 100.0,
                           end_ratio: float = 1e-3,
                           step_ratio_up: float = 0.1
                           ) -> Callable[[int], float]:
    """``step -> learning rate``; step 0 is the first update."""
    up_steps = max(int(total_steps * step_ratio_up), 1)
    peak = base_lr * peak_ratio
    end = peak * end_ratio

    def cos_seg(t, lo, hi):
        # cosine interpolation from lo (t=0) to hi (t=1)
        return hi + (lo - hi) * 0.5 * (1 + math.cos(math.pi * t))

    def schedule(step: int) -> float:
        if step < up_steps:
            return cos_seg(min(max(step / up_steps, 0.0), 1.0), base_lr,
                           peak)
        t = (step - up_steps) / max(total_steps - up_steps, 1)
        return cos_seg(min(max(t, 0.0), 1.0), peak, end)

    return schedule


def decays(name: str) -> bool:
    """Whether weight decay applies to the parameter ``name`` (a
    ``named_parameters`` key): not to norm parameters (any module whose name
    holds "norm", or is "ln") and not to biases. On the port's models that
    decays exactly the Linear and Conv weights, the same parameters as the
    JAX package's ``_no_decay_mask``."""
    parts = name.split(".")
    in_norm = any("norm" in p.lower() or p == "ln" for p in parts)
    return not (in_norm or parts[-1] == "bias")


def make_optimizer(named_params: Iterable[tuple[str, torch.nn.Parameter]],
                   base_lr: float, total_steps: int,
                   weight_decay: float = 0.05, peak_ratio: float = 100.0,
                   frozen_prefixes: tuple = ()):
    """AdamW over two parameter groups (decayed, not decayed) and the
    schedule. Returns ``(optimizer, schedule)``; the caller sets each
    group's ``lr`` to ``schedule(step)`` before step ``step`` (from 0, as
    optax counts) and clips with :func:`clip_grad_global_norm_`.

    ``frozen_prefixes``: parameters whose name contains one of these
    strings get no update and no Adam moments (they are in no group), the
    reference's frozen auto-encoder mode."""
    groups = {True: [], False: []}
    for name, p in named_params:
        if not p.requires_grad or any(f in name for f in frozen_prefixes):
            continue
        groups[decays(name)].append(p)
    schedule = cyclic_cosine_schedule(base_lr, total_steps,
                                      peak_ratio=peak_ratio)
    opt = torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": weight_decay},
         {"params": groups[False], "weight_decay": 0.0}],
        lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    return opt, schedule


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def clip_grad_global_norm_(params: Iterable[torch.Tensor],
                           max_norm: float = 10.0) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: where the gradients' global norm is
    at least ``max_norm``, each gradient becomes ``g / norm * max_norm``;
    below it they are left as they are (no epsilon). Returns the norm before
    clipping. Runs on the device, without a host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.stack([g.float().square().sum() for g in grads]).sum() \
        .sqrt()
    clip = norm >= max_norm
    div = torch.where(clip, norm, torch.ones_like(norm))
    mul = torch.where(clip, torch.full_like(norm, max_norm),
                      torch.ones_like(norm))
    for g in grads:
        g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
    return norm
