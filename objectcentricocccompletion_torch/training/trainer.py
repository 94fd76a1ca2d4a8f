"""The OcOccNet training loop, and the checkpoints and metric logs of
every training loop (counterpart of the JAX package's
``training/trainer.py``: ``train``, ``CheckpointManager`` and
``MetricLogger``)."""
from __future__ import annotations

import contextlib
import json
import os
import re
import time
from typing import Callable, Sequence

import torch

from ..data.loader import ThreadPrefetcher, make_loader
from ..parallel.multihost import (data_rank, data_size, make_multihost_mesh,
                                  rank, sync_hosts)
from ..parallel.train import create_train_state, make_train_step
from ..utils.device import resolve_device


class CheckpointManager:
    """``ckpt_dir/step_<N>.pt`` files holding the step, the model's
    ``state_dict`` and the optimizer's state; the newest ``max_keep`` are
    kept. A published or transplanted checkpoint (``training/surgery.py``)
    holds no optimizer state. The tensors are whole: a model-parallel run
    saves the state its layout gathered (``Layout.full_state``), so any
    process count restores any checkpoint."""

    _NAME = re.compile(r"^step_(\d+)\.pt$")

    def __init__(self, ckpt_dir: str, max_keep: int = 1):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.max_keep = max_keep

    def steps(self) -> list[int]:
        return sorted(int(m[1]) for f in os.listdir(self.dir)
                      if (m := self._NAME.match(f)))

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.pt")

    def save(self, step: int, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer,
             state: tuple[dict, dict] | None = None) -> str:
        """Write step ``step``: ``model``'s and ``optimizer``'s state dicts,
        or ``state`` (the two, gathered whole by a model-parallel layout)
        where it is given."""
        path = self.path(step)
        tmp = path + ".tmp"
        if state is None:
            state = model.state_dict(), optimizer.state_dict()
        torch.save({"step": step, "model": state[0],
                    "optimizer": state[1]}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, model: torch.nn.Module,
                optimizer: torch.optim.Optimizer | None = None
                ) -> int | None:
        """Load the newest checkpoint into ``model`` and, where one is
        given and the checkpoint holds its state, ``optimizer``
        (evaluation passes none; a checkpoint without optimizer state, as
        ``publish_model transplant`` writes, leaves the fresh AdamW as it
        is); returns its step, or None where there is none."""
        steps = self.steps()
        if not steps:
            return None
        state = torch.load(self.path(steps[-1]), map_location="cpu",
                           weights_only=True)
        model.load_state_dict(state["model"])
        if optimizer is not None and "optimizer" in state:
            optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])


class MetricLogger:
    """Appends one JSON line per logged step to ``log_dir/metrics.jsonl``:
    the step, seconds since the logger started, and every metric that
    converts to a float (rounded to 6 decimals)."""

    def __init__(self, log_dir: str, interval: int = 50):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.interval = interval
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict) -> None:
        if step % self.interval:
            return
        rec = {"step": step, "time": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            try:
                rec[k] = round(float(v), 6)
            except (TypeError, ValueError):
                pass
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def train(cfg, dataset, work_dir: str, total_steps: int | None = None,
          ckpt_interval: int = 1000, log_interval: int = 50,
          resume: bool = True, seed: int = 0, device="cuda",
          hooks: Sequence[Callable[[int, dict], None]] = (),
          loader_workers: int = 0, tp: int = 1, fsdp: bool = False,
          sequence_parallel: bool = False) -> int:
    """Train OcOccNet (``cfg``) on ``dataset`` (a ``TrackletDataset``) on
    ``device`` (``cuda`` unless the caller asks for the CPU), from weights
    drawn with ``seed``: ``cfg.batch_size`` tracklets per step and
    process, ``total_steps`` steps (default ``cfg.max_epochs`` epochs of
    the global batch). Metrics go to ``work_dir/metrics.jsonl`` every
    ``log_interval`` steps with ``lr`` (the step's) and
    ``tracklets_per_sec``; a checkpoint to ``work_dir/ckpt`` every
    ``ckpt_interval`` steps and at the end; with ``resume`` the newest
    checkpoint there is loaded first. A thread builds the next batches
    while the device runs; with ``loader_workers`` above 0 it collects them
    from that many sample-building processes (``PrefetchLoader``), whose
    batches are the same for any count. Each hook is called as
    ``hook(step, metrics)`` after every step (``step`` counts the steps
    done). Returns the number of steps done.

    Under a process group (``parallel/multihost.py::initialize``) the
    global batch is ``cfg.batch_size`` times the world size, as in the JAX
    trainer: every rank draws it from the loader's seed and keeps its
    contiguous slice, and the step is data-parallel
    (``parallel/train.py``), so the run equals one process at the global
    batch. Rank 0 writes the checkpoints and the log, between barriers;
    every rank resumes from the same file and runs its hooks.

    Model parallelism, as the JAX trainer's arguments: ``tp`` > 1 lays the
    ranks out on a ``[world / tp, tp]`` data x model mesh
    (``make_multihost_mesh``) and shards the wide Dense layers over the
    model axis; ``fsdp`` shards the large parameters and their AdamW
    moments over the data axis (and wins over TP: the model axis then
    serves SP only); ``sequence_parallel`` also splits the packed points
    and the decoder's queries over the model axis, and needs ``tp`` > 1.
    The global batch is ``cfg.batch_size`` times the data axis's size; the
    model ranks of one data rank train on its slice. Checkpoints hold whole
    tensors, gathered by every rank and written by rank 0; a resumed run
    restores the whole file on every rank and keeps its shards."""
    dev = resolve_device(device)
    if sequence_parallel and tp <= 1:
        raise ValueError("sequence parallelism needs a model axis: tp > 1")
    mesh = make_multihost_mesh(tp, dev.type) if tp > 1 or fsdp else None
    shards, me = data_size(mesh), rank()
    batch_size = cfg.batch_size * shards
    if total_steps is None:
        total_steps = max(len(dataset) // batch_size, 1) * cfg.max_epochs
    loader = ThreadPrefetcher(make_loader(dataset, batch_size, seed=seed,
                                          workers=loader_workers,
                                          num_shards=shards,
                                          shard_id=data_rank(mesh)),
                              depth=2)
    try:
        model, optimizer, schedule = create_train_state(cfg, total_steps,
                                                        dev, seed)
        ckpt = CheckpointManager(os.path.join(work_dir, "ckpt"))
        start = 0
        if resume:
            restored = ckpt.restore(model, optimizer)
            if restored is not None:
                start = restored
        step_fn = make_train_step(model, optimizer, schedule, seed=seed + 1,
                                  mesh=mesh, fsdp=fsdp,
                                  sequence_parallel=sequence_parallel)
        layout = step_fn.layout
        t_last = time.time()
        with contextlib.ExitStack() as stack:
            logger = (stack.enter_context(MetricLogger(work_dir,
                                                       log_interval))
                      if me == 0 else None)
            for step in range(start, total_steps):
                metrics = step_fn(step, next(loader))
                for hook in hooks:
                    hook(step + 1, metrics)
                if (step + 1) % log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = (time.time() - t_last) / log_interval
                    t_last = time.time()
                    if logger is not None:
                        logger.log(step + 1, {
                            **metrics, "lr": schedule(step),
                            "tracklets_per_sec": batch_size / max(dt,
                                                                  1e-9)})
                if (step + 1) % ckpt_interval == 0 or step + 1 == total_steps:
                    sync_hosts("ckpt_save")
                    whole = (layout.full_state(model, optimizer)
                             if layout.dims else None)
                    if me == 0:
                        ckpt.save(step + 1, model, optimizer, whole)
                    sync_hosts("ckpt_saved")
    finally:
        loader.close()
    return max(start, total_steps)
