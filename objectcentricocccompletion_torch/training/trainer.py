"""Checkpoints and metric logs of the training loops (counterpart of the
JAX package's ``training/trainer.py::CheckpointManager`` and
``MetricLogger``)."""
from __future__ import annotations

import json
import os
import re
import time

import torch


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
