"""Profiling and tracing utilities (counterpart of the JAX package's
``utils/profiling.py``): a step timer that synchronises the card, a context
manager around ``torch.profiler`` that writes a Chrome / Perfetto trace, and
named spans in it.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity


class StepTimer:
    """Rolling step timing, synchronised with the card, reported every
    ``report_every`` steps."""

    def __init__(self, name: str = "step", report_every: int = 50):
        self.name = name
        self.report_every = report_every
        self._count = 0
        self._acc = 0.0
        self._t = None

    def start(self):
        self._t = time.perf_counter()

    def stop(self, sync_on: torch.Tensor | torch.device | str | None = None):
        """End the step; with ``sync_on`` (a tensor or a device) first wait
        for the card that holds it to finish its queued work."""
        if sync_on is not None:
            dev = (sync_on.device if isinstance(sync_on, torch.Tensor)
                   else torch.device(sync_on))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self._acc += time.perf_counter() - self._t
        self._count += 1
        if self._count % self.report_every == 0:
            avg = self._acc / self.report_every
            self._acc = 0.0
            print(f"[{self.name}] avg {avg * 1000:.1f} ms "
                  f"over last {self.report_every} steps")


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (the host, and the
    card where there is one) and write it to ``log_dir/trace.json`` (open it
    in Perfetto or ``chrome://tracing``). Yields the profiler (its
    ``key_averages()`` sum the operators), or None where it cannot start:
    then the block runs untraced, as in the JAX package.

    Usage:
        with trace("/tmp/torch-trace"):
            step_fn(...)  # traced region
    """
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.start()
    except RuntimeError as e:
        print(f"profiler unavailable: {e}")
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            except (RuntimeError, OSError) as e:
                print(f"profiler stop failed: {e}")


def annotate(name: str):
    """A named span in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
