"""Optimizer and learning-rate schedule (counterpart of the JAX package's
``training/optim.py``: ``cyclic_cosine_schedule``, ``_no_decay_mask``,
``make_optimizer``, and ``make_flat_optimizer`` / ``make_stacked_optimizer``
over :class:`BufferAdamW`).

The reference recipe: AdamW(0.9, 0.999, eps 1e-8), weight decay 0.05 on
every parameter but norms and biases, global-norm gradient clip 10, and
mmcv's one-cycle "cyclic" schedule (cosine ramp from base_lr to 100x over
the first 10% of steps, then cosine anneal to 100x * 1e-3 * base_lr).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
import torch.distributed as dist


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


def _square_sum(tensors) -> torch.Tensor | None:
    sums = [t.float().square().sum() for t in tensors]
    return torch.stack(sums).sum() if sums else None


def global_norm(tensors: Iterable[torch.Tensor],
                sharded: Iterable[torch.Tensor] = (),
                group=None) -> torch.Tensor:
    """optax's ``global_norm``: the square root of the sum of squares of
    every element, in float32, on the device. ``sharded``: tensors of
    which each rank of ``group`` holds a disjoint chunk (a model-parallel
    layout's shards), whose squares are summed over the group, so that the
    norm is the whole tensors' on every rank."""
    total = _square_sum(tensors)
    part = _square_sum(sharded)
    if part is not None:
        if dist.is_available() and dist.is_initialized():
            dist.all_reduce(part, group=group)
        total = part if total is None else total + part
    return total.sqrt()


def clip_grad_global_norm_(params: Iterable[torch.Tensor],
                           max_norm: float = 10.0,
                           sharded: Iterable[torch.Tensor] = (),
                           group=None) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: where the gradients' global norm is
    at least ``max_norm``, each gradient becomes ``g / norm * max_norm``;
    below it they are left as they are (no epsilon). Returns the norm before
    clipping. Runs on the device, without a host synchronisation.
    ``sharded``: parameters whose gradients are chunks over ``group``
    (:func:`global_norm`)."""
    grads = [p.grad for p in params if p.grad is not None]
    shards = [p.grad for p in sharded if p.grad is not None]
    norm = global_norm(grads, shards, group)
    grads = grads + shards
    clip = norm >= max_norm
    div = torch.where(clip, norm, torch.ones_like(norm))
    mul = torch.where(clip, torch.full_like(norm, max_norm),
                      torch.ones_like(norm))
    for g in grads:
        g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
    return norm


def make_flat_optimizer(flat_params: dict[str, torch.Tensor],
                        base_lr: float, total_steps: int,
                        weight_decay: float = 0.05, grad_clip: float = 10.0,
                        peak_ratio: float = 100.0):
    """The recipe of :func:`make_optimizer` over the two flat vectors
    ``{"decay": vec, "nodecay": vec}`` that hold every parameter
    (``parallel/train.py::make_flat_opt_spec``; the JAX package's
    ``make_flat_optimizer``). Returns ``(optimizer, schedule)``. Frozen
    parameters are not supported: use the tree optimizer there."""
    return (BufferAdamW(flat_params, {k: k == "decay" for k in flat_params},
                        weight_decay, grad_clip),
            cyclic_cosine_schedule(base_lr, total_steps,
                                   peak_ratio=peak_ratio))


def make_stacked_optimizer(stacked_params: dict[str, torch.Tensor],
                           base_lr: float, total_steps: int,
                           weight_decay: float = 0.05,
                           grad_clip: float = 10.0,
                           peak_ratio: float = 100.0):
    """The same recipe over shape-grouped ``[count, *shape]`` stacks
    (``parallel/train.py::make_stacked_opt_spec``; the JAX package's
    ``make_stacked_optimizer``): a stack decays where its key starts with
    "d". Returns ``(optimizer, schedule)``."""
    return (BufferAdamW(stacked_params,
                        {k: k.startswith("d") for k in stacked_params},
                        weight_decay, grad_clip),
            cyclic_cosine_schedule(base_lr, total_steps,
                                   peak_ratio=peak_ratio))


class BufferAdamW:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(lr, 0.9, 0.999,
    eps=1e-8, weight_decay, mask))`` over a few contiguous buffers that hold
    every parameter: ``params`` (key -> buffer), the gradients in buffers
    of the same layout (``grads``), ``decay`` (key -> whether weight decay
    applies). The parameters bound with :meth:`bind` are views of
    ``params`` and their gradients views of ``grads``, so the backward
    accumulates into the buffers and the clip and the update are a few
    ``torch._foreach_*`` launches over all of them, whatever the number of
    parameters. The update is ``torch.optim.AdamW``'s, operation for
    operation (so a step matches the tree optimizer's of
    :func:`make_optimizer`): optax's AdamW in another order of the same
    operations, its bias corrections in float64."""

    def __init__(self, params: dict[str, torch.Tensor],
                 decay: dict[str, bool], weight_decay: float = 0.05,
                 grad_clip: float = 10.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.grads = {k: torch.zeros_like(v) for k, v in params.items()}
        self.exp_avg = {k: torch.zeros_like(v) for k, v in params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(v) for k, v in params.items()}
        self.decay = decay
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.bound: tuple = ()

    def bind(self, params, views, grad_views) -> None:
        """Make each of ``params`` the view of the buffers that holds its
        value (``views``, in the parameters' own layout) and its gradient a
        view of the gradient buffers (``grad_views``)."""
        for p, v, g in zip(params, views, grad_views):
            p.data = v
            p.grad = g
        self.bound = tuple(zip(params, grad_views))

    def zero_grad(self) -> None:
        """Zero the gradient buffers and point every bound parameter's
        gradient at its view again (a ``zero_grad(set_to_none=True)`` of the
        module unbinds them)."""
        torch._foreach_zero_(list(self.grads.values()))
        for p, g in self.bound:
            p.grad = g

    @torch.no_grad()
    def step(self, lr: float) -> torch.Tensor:
        """Clip by the global norm, then one AdamW update at ``lr``. Returns
        the gradients' global norm before the clip (optax's
        ``global_norm``), a 0-d tensor on the device."""
        keys = list(self.params)
        grads = [self.grads[k] for k in keys]
        # each buffer's norm accumulated in float64 (a float32 norm of a
        # long vector drifts by up to 1e-5 relative on the CPU)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            grads, 2, dtype=torch.float64))).float()
        clip = norm >= self.grad_clip
        torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
        torch._foreach_mul_(grads, torch.where(
            clip, torch.full_like(norm, self.grad_clip), 1.0))
        self.count += 1
        params = [self.params[k] for k in keys]
        mu = [self.exp_avg[k] for k in keys]
        nu = [self.exp_avg_sq[k] for k in keys]
        dec = [p for k, p in zip(keys, params) if self.decay[k]]
        if dec and self.weight_decay:
            torch._foreach_mul_(dec, 1 - lr * self.weight_decay)
        torch._foreach_lerp_(mu, grads, 1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        den = torch._foreach_sqrt(nu)
        torch._foreach_div_(den, math.sqrt(1 - self.b2 ** self.count))
        torch._foreach_add_(den, self.eps)
        torch._foreach_addcdiv_(params, mu, den,
                                -lr / (1 - self.b1 ** self.count))
        return norm
