"""Training loop of the single-frame detectors (counterpart of the JAX
package's ``training/detector_trainer.py``).

A detector is a single-sample module (one padded frame per call). Where the
JAX step vmaps the loss over a frame batch, the port loops over the batch's
frames, a forward and a backward each (one frame's graph held at a time);
each entry of the loss dict is the mean over the frames, and the gradient
is that of the mean loss.

Data parallelism (a process group up, ``parallel/multihost.py``): the
global batch is ``batch_size`` frames per process, every rank draws it and
keeps its contiguous slice (``FrameLoader``), and each frame's loss goes
through ``DistributedDataParallel`` (``FrameLoss``), inside ``no_sync``
for all but the rank's last frame, so the gradients are all-reduced once
per step and every rank holds one frame's graph, as one process does. The
loss is a mean over frames, so equal slices average to the global batch's
with no global denominator; the logged means are averaged over the ranks.
SST's window-attention kernels run their forward and backward on every
rank, and DDP's reducer hooks take the gradients their
``autograd.Function`` returns.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..data.loader import shard_slice
from ..parallel.multihost import rank, sync_hosts, world_size
from ..parallel.train import mean_over_ranks, wrap_ddp
from ..utils.device import resolve_device
from .optim import clip_grad_global_norm_, make_optimizer, set_lr
from .trainer import CheckpointManager, MetricLogger


class FrameBatch(NamedTuple):
    points: torch.Tensor       # [B, N, C] float32
    points_mask: torch.Tensor  # [B, N] bool
    gt_boxes: torch.Tensor     # [B, M, 7] float32
    gt_labels: torch.Tensor    # [B, M] int32
    gt_valid: torch.Tensor     # [B, M] bool

    def to(self, device) -> "FrameBatch":
        return FrameBatch(*(t.to(device, non_blocking=True) for t in self))


def collate_frames(samples: list[dict]) -> FrameBatch:
    """Stack the samples' arrays into CPU tensors."""
    def stack(k):
        return torch.from_numpy(np.stack([s[k] for s in samples], 0))
    return FrameBatch(stack("points"), stack("points_mask"),
                      stack("gt_boxes"), stack("gt_labels"),
                      stack("gt_valid"))


class FrameLoader:
    """Endless batches of ``dataset.build_sample``: a new permutation of the
    dataset (from ``numpy.random.RandomState(seed)``) whenever the last one
    runs out, taken from its end; the same state feeds the samples' own
    randomness. The JAX package's loader (one shard), draw for draw.

    ``batch_size`` is the global batch; shard ``shard_id`` of
    ``num_shards`` keeps its contiguous slice of each, so the ranks train
    on the one-process run's frames. The state feeds the augmentation, so
    each shard builds every frame of the global batch (``num_shards``
    times its own slice's host work). The JAX package's ``num_shards`` /
    ``shard_id`` (unused there) take an interleaved slice of each
    permutation instead."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_shards: int = 1, shard_id: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.keep = shard_slice(batch_size, num_shards, shard_id)
        self.rng = np.random.RandomState(seed)
        self._order = []

    def __iter__(self):
        return self

    def __next__(self) -> FrameBatch:
        out = []
        while len(out) < self.batch_size:
            if not self._order:
                self._order = list(self.rng.permutation(len(self.ds)))
            s = self.ds.build_sample(self._order.pop(), self.rng)
            s.pop("meta", None)
            out.append(s)
        return collate_frames(out[self.keep])


class FrameLoss(torch.nn.Module):
    """``model.loss`` of one frame as a module's forward: the module that
    DDP wraps."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, points, points_mask, gt_boxes, gt_labels, gt_valid):
        return self.model.loss(points, points_mask, gt_boxes, gt_labels,
                               gt_valid)


def make_detector_train_step(model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer,
                             schedule: Callable[[int], float],
                             grad_clip: float = 10.0):
    """``step_fn(step, batch) -> metrics``: one AdamW step at learning rate
    ``schedule(step)`` on the mean loss of the batch's frames, after a
    global-norm clip. ``model`` exposes ``loss(points, mask, gt_boxes,
    gt_labels, gt_valid) -> dict`` with a ``loss`` entry. The metrics are
    the means of the loss dict's entries over the frames and ``grad_norm``,
    the gradients' global norm before clipping (0-d tensors on the model's
    device; reading them synchronises). Under a process group the batch is
    the rank's slice, the gradients are DDP's average over the ranks
    (``find_unused_parameters``: a regression branch without positives
    takes no gradient) and the metrics the global batch's."""
    params = [p for group in optimizer.param_groups
              for p in group["params"]]
    device = next(model.parameters()).device
    frames = FrameLoss(model)
    ddp = wrap_ddp(frames, find_unused_parameters=True)

    def step_fn(step: int, batch: FrameBatch) -> dict:
        model.train()
        batch = batch.to(device)
        set_lr(optimizer, schedule(step))
        optimizer.zero_grad(set_to_none=True)
        n = batch.points.shape[0]
        sums: dict[str, torch.Tensor] = {}
        for i in range(n):
            sync = (ddp.no_sync() if ddp is not frames and i < n - 1
                    else contextlib.nullcontext())
            with sync:
                losses = ddp(*(t[i] for t in batch))
                (losses["loss"] / n).backward()
            for k, v in losses.items():
                v = v.detach().float()
                sums[k] = sums[k] + v if k in sums else v
        means = {k: v / n for k, v in sums.items()}
        grad_norm = clip_grad_global_norm_(params, grad_clip)
        optimizer.step()
        return {**mean_over_ranks(means, list(means)),
                "grad_norm": grad_norm}

    return step_fn


def train_detector(model: torch.nn.Module, dataset, work_dir: str,
                   total_steps: int, batch_size: int = 1,
                   base_lr: float = 1e-5, ckpt_interval: int = 1000,
                   log_interval: int = 50, seed: int = 0, device="cuda",
                   resume: bool = True,
                   hooks: Sequence[Callable[[int, dict], None]] = (),
                   disable_aug_after: int | None = None) -> int:
    """Train ``model`` (its weights as given) on ``dataset`` for
    ``total_steps`` steps on ``device`` (``cuda`` unless the caller asks
    for the CPU), ``batch_size`` frames per step and process (under a
    process group the global batch is ``batch_size`` times the world size,
    each rank on its slice; rank 0 writes the checkpoints and the log,
    between barriers, and every rank resumes from the same file). Metrics
    go to ``work_dir/metrics.jsonl`` every ``log_interval`` steps, with
    ``frames_per_sec``; a checkpoint to ``work_dir/ckpt`` every
    ``ckpt_interval`` steps and at the end; with ``resume`` the newest
    checkpoint there is loaded first. Each hook is
    called as ``hook(step, metrics)`` after every step (``step`` counts the
    steps done). ``disable_aug_after`` turns the dataset's geometry
    augmentation and GT paste off from that step on, before its batch is
    drawn (the reference's ``DisableAugmentationHook``,
    ``core/hook/fsd_hooks.py:7-54``). Returns the number of steps done."""
    dev = resolve_device(device)
    model.to(dev)
    world, me = world_size(), rank()
    global_batch = batch_size * world
    loader = FrameLoader(dataset, global_batch, seed=seed, num_shards=world,
                         shard_id=me)
    batch = next(loader)
    optimizer, schedule = make_optimizer(model.named_parameters(), base_lr,
                                         total_steps)
    ckpt = CheckpointManager(f"{work_dir}/ckpt")
    start = 0
    if resume:
        restored = ckpt.restore(model, optimizer)
        if restored is not None:
            start = restored
    step_fn = make_detector_train_step(model, optimizer, schedule)
    t_last = time.time()
    with contextlib.ExitStack() as stack:
        logger = (stack.enter_context(MetricLogger(work_dir, log_interval))
                  if me == 0 else None)
        for step in range(start, total_steps):
            if disable_aug_after is not None and step >= disable_aug_after:
                dataset.augment = False
                dataset.db_sampler = None
                disable_aug_after = None
            metrics = step_fn(step, next(loader) if step > start else batch)
            for hook in hooks:
                hook(step + 1, metrics)
            if (step + 1) % log_interval == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = (time.time() - t_last) / log_interval
                t_last = time.time()
                if logger is not None:
                    logger.log(step + 1, {
                        **metrics, "frames_per_sec": global_batch / dt})
            if (step + 1) % ckpt_interval == 0 or step + 1 == total_steps:
                sync_hosts("ckpt_save")
                if me == 0:
                    ckpt.save(step + 1, model, optimizer)
                sync_hosts("ckpt_saved")
    return max(start, total_steps)
