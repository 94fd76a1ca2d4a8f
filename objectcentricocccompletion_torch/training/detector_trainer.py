"""Training loop of the single-frame detectors (counterpart of the JAX
package's ``training/detector_trainer.py``; the SST family so far).

A detector is a single-sample module (one padded frame per call). Where the
JAX step vmaps the loss over a frame batch, the port loops over the batch's
frames; each entry of the loss dict is the mean over the frames, and the
gradient is that of the mean loss. One device, no mesh.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

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
    randomness. The JAX package's loader (one shard), draw for draw."""

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
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
        return collate_frames(out)


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
    device; reading them synchronises)."""
    params = [p for group in optimizer.param_groups
              for p in group["params"]]
    device = next(model.parameters()).device

    def step_fn(step: int, batch: FrameBatch) -> dict:
        model.train()
        batch = batch.to(device)
        n = batch.points.shape[0]
        set_lr(optimizer, schedule(step))
        optimizer.zero_grad(set_to_none=True)
        sums: dict[str, torch.Tensor] = {}
        for i in range(n):
            losses = model.loss(batch.points[i], batch.points_mask[i],
                                batch.gt_boxes[i], batch.gt_labels[i],
                                batch.gt_valid[i])
            (losses["loss"] / n).backward()
            for k, v in losses.items():
                v = v.detach().float()
                sums[k] = sums[k] + v if k in sums else v
        grad_norm = clip_grad_global_norm_(params, grad_clip)
        optimizer.step()
        return {**{k: v / n for k, v in sums.items()},
                "grad_norm": grad_norm}

    return step_fn


def train_detector(model: torch.nn.Module, dataset, work_dir: str,
                   total_steps: int, batch_size: int = 1,
                   base_lr: float = 1e-5, ckpt_interval: int = 1000,
                   log_interval: int = 50, seed: int = 0, device="cuda",
                   resume: bool = True,
                   hooks: Sequence[Callable[[int, dict], None]] = ()
                   ) -> int:
    """Train ``model`` (its weights as given) on ``dataset`` for
    ``total_steps`` steps on ``device`` (``cuda`` unless the caller asks
    for the CPU). Metrics go to ``work_dir/metrics.jsonl`` every
    ``log_interval`` steps, with ``frames_per_sec``; a checkpoint to
    ``work_dir/ckpt`` every ``ckpt_interval`` steps and at the end; with
    ``resume`` the newest checkpoint there is loaded first. Each hook is
    called as ``hook(step, metrics)`` after every step (``step`` counts the
    steps done). Returns the number of steps done."""
    dev = resolve_device(device)
    model.to(dev)
    loader = FrameLoader(dataset, batch_size, seed=seed)
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
    with MetricLogger(work_dir, log_interval) as logger:
        for step in range(start, total_steps):
            metrics = step_fn(step, next(loader) if step > start else batch)
            for hook in hooks:
                hook(step + 1, metrics)
            if (step + 1) % log_interval == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = (time.time() - t_last) / log_interval
                t_last = time.time()
                logger.log(step + 1, {**metrics,
                                      "frames_per_sec": batch_size / dt})
            if (step + 1) % ckpt_interval == 0 or step + 1 == total_steps:
                ckpt.save(step + 1, model, optimizer)
    return max(start, total_steps)
