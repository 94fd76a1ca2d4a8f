"""The OcOccNet training loop, and the checkpoints and metric logs of
every training loop (counterpart of the JAX package's
``training/trainer.py``: ``train``, ``CheckpointManager`` and
``MetricLogger``)."""
from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Sequence

import torch

from ..data.loader import ThreadPrefetcher, make_loader
from ..parallel.train import create_train_state, make_train_step
from ..utils.device import resolve_device


class CheckpointManager:
    """``ckpt_dir/step_<N>.pt`` files holding the step, the model's
    ``state_dict`` and the optimizer's state; the newest ``max_keep`` are
    kept."""

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
             optimizer: torch.optim.Optimizer) -> str:
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save({"step": step, "model": model.state_dict(),
                    "optimizer": optimizer.state_dict()}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, model: torch.nn.Module,
                optimizer: torch.optim.Optimizer) -> int | None:
        """Load the newest checkpoint into ``model`` and ``optimizer``;
        returns its step, or None where there is none."""
        steps = self.steps()
        if not steps:
            return None
        state = torch.load(self.path(steps[-1]), map_location="cpu",
                           weights_only=True)
        model.load_state_dict(state["model"])
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
          hooks: Sequence[Callable[[int, dict], None]] = ()) -> int:
    """Train OcOccNet (``cfg``) on ``dataset`` (a ``TrackletDataset``) on
    one device (``cuda`` unless the caller asks for the CPU), from weights
    drawn with ``seed``: ``cfg.batch_size`` tracklets per step,
    ``total_steps`` steps (default ``cfg.max_epochs`` epochs). Metrics go
    to ``work_dir/metrics.jsonl`` every ``log_interval`` steps with ``lr``
    (the step's) and ``tracklets_per_sec``; a checkpoint to
    ``work_dir/ckpt`` every ``ckpt_interval`` steps and at the end; with
    ``resume`` the newest checkpoint there is loaded first. A thread builds
    the next batches while the device runs.
    Each hook is called as ``hook(step, metrics)`` after every step
    (``step`` counts the steps done). Returns the number of steps done."""
    dev = resolve_device(device)
    batch_size = cfg.batch_size
    if total_steps is None:
        total_steps = max(len(dataset) // batch_size, 1) * cfg.max_epochs
    loader = ThreadPrefetcher(make_loader(dataset, batch_size, seed=seed),
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
        step_fn = make_train_step(model, optimizer, schedule, seed=seed + 1)
        t_last = time.time()
        with MetricLogger(work_dir, log_interval) as logger:
            for step in range(start, total_steps):
                metrics = step_fn(step, next(loader))
                for hook in hooks:
                    hook(step + 1, metrics)
                if (step + 1) % log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = (time.time() - t_last) / log_interval
                    t_last = time.time()
                    logger.log(step + 1, {
                        **metrics, "lr": schedule(step),
                        "tracklets_per_sec": batch_size / max(dt, 1e-9)})
                if (step + 1) % ckpt_interval == 0 or step + 1 == total_steps:
                    ckpt.save(step + 1, model, optimizer)
    finally:
        loader.close()
    return max(start, total_steps)
