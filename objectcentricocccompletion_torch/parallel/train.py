"""The OcOccNet training step (counterpart of the JAX package's
``parallel/train.py``: ``create_train_state`` and the data-parallel body of
``make_train_step`` and ``make_train_multi_step`` with the tree optimizer).

A step runs the loss, the backward, the gradients' global norm (before the
clip, as ``optax.global_norm(grads)``), the clip at ``cfg.grad_clip_norm``
and AdamW at ``schedule(step)``, step counted from 0. The parameters stay
float32; ``cfg.compute_dtype`` sets the compute dtype. Dropout draws its
keys on the device from ``[seed, step]``, so a step reads nothing back to
the host.

Data parallelism (a process group up, ``parallel/multihost.py``): each
rank holds the whole model and its slice of the global batch, and the loss
goes through ``DistributedDataParallel`` (one forward per backward), whose
reducer all-reduces every parameter's gradient, the frozen auto-encoder's
under ``fixed_ae`` too (the JAX ``grad_norm`` covers it). DDP rather than
an all-reduce after ``backward()``: it overlaps the buckets' all-reduce
with the backward, and every OcOccNet / CTRL parameter takes a gradient in
every step, as DDP without ``find_unused_parameters`` needs. The loss's
positive counts are the global batch's (``global_sum``), dropout offsets
its counter by the rank (``models/layers.py::DropoutKeys``), and the logged
loss entries are the ranks' mean: the run equals one process on the global
batch. The clip and AdamW then run on equal gradients on every rank. No
mesh, tensor or sequence parallelism, FSDP, nor the flat or stacked
optimizer (the JAX package's ways around the TPU's launch overhead).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..configs.ococcnet_config import OcOccNetConfig
from ..data.tracklet import TrackletBatch
from ..models.layers import DropoutKeys
from ..models.ococcnet import OcOccNetWithLoss
from ..training.optim import (clip_grad_global_norm_, global_norm,
                              make_optimizer, set_lr)
from .multihost import global_sum, rank, world_size

__all__ = ["create_train_state", "frozen_prefixes", "global_sum",
           "make_train_multi_step", "make_train_step", "mean_over_ranks",
           "wrap_ddp"]


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


def wrap_ddp(model: torch.nn.Module,
             find_unused_parameters: bool = False) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` where a process group is up
    (of any size: one rank runs DDP's reducer too), else ``model`` itself.
    Its buffers are constants of the config and are not broadcast; the
    parameters are broadcast from rank 0 once."""
    if not (dist.is_available() and dist.is_initialized()):
        return model
    return DistributedDataParallel(
        model, broadcast_buffers=False,
        find_unused_parameters=find_unused_parameters)


def mean_over_ranks(metrics: dict, keys) -> dict:
    """``metrics`` with the entries of ``keys`` replaced by their mean over
    the ranks (one all-reduce); the identity in one process."""
    keys = [k for k in keys if k in metrics]
    if world_size() == 1 or not keys:
        return metrics
    vals = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(vals, op=dist.ReduceOp.SUM)
    vals = vals / world_size()
    return {**metrics, **{k: vals[i] for i, k in enumerate(keys)}}


def make_train_step(model: OcOccNetWithLoss,
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], seed: int = 0):
    """``step_fn(step, batch) -> metrics``: one training step on ``batch``
    (moved to the model's device; under data parallelism the rank's slice
    of the global batch). The metrics are the loss dict and
    ``grad_norm``, 0-d tensors on the device (reading them synchronises),
    the global batch's under data parallelism. Under ``fixed_ae`` the clip,
    as in the JAX package, sees the trained parameters' gradients only, and
    ``grad_norm`` all of them."""
    cfg = model.cfg
    device = model.code_weights.device
    trained = [p for group in optimizer.param_groups
               for p in group["params"]]
    params = list(model.parameters())
    frozen = len(trained) != len(params)
    loss_fn = wrap_ddp(model)
    shard = rank()
    # [seed, step]: the dropout keys' base, updated in place on the device
    base = torch.tensor([seed, 0], dtype=torch.int64, device=device)

    def step_fn(step: int, batch: TrackletBatch) -> dict:
        batch = batch.to(device)
        base[1].fill_(step)
        set_lr(optimizer, schedule(step))
        model.zero_grad(set_to_none=True)
        total, aux = loss_fn(batch, train=True,
                             keys=DropoutKeys(base, rank=shard))
        total.backward()
        every = (global_norm(p.grad for p in params if p.grad is not None)
                 if frozen else None)
        norm = clip_grad_global_norm_(trained, cfg.grad_clip_norm)
        optimizer.step()
        aux = mean_over_ranks({k: v.detach() for k, v in aux.items()},
                              [k for k in aux if k.startswith("loss")])
        return {**aux, "grad_norm": norm if every is None else every}

    return step_fn


def make_train_multi_step(model: OcOccNetWithLoss,
                          optimizer: torch.optim.Optimizer,
                          schedule: Callable[[int], float], seed: int = 0):
    """``multi_fn(step, batches) -> metrics``: ``K`` steps from ``step`` on
    a batch whose every tensor carries a leading ``[K]`` axis (``[K, B,
    ...]``), each metric stacked ``[K]``. The JAX package scans the step
    in one program to save the TPU's dispatches; here it is a loop over
    :func:`make_train_step`'s step, whose dropout counter follows the step
    (step ``step + k`` of the loop draws the masks of a lone step there)."""
    step_fn = make_train_step(model, optimizer, schedule, seed)

    def multi_fn(step: int, batches: TrackletBatch) -> dict:
        rows = [step_fn(step + k, TrackletBatch(*(x[k] for x in batches)))
                for k in range(batches.points.shape[0])]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return multi_fn
