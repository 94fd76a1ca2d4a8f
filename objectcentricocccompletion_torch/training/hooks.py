"""Training schedule hooks (a copy of the JAX package's
``training/hooks.py``).

Rebuild of the reference's runtime hooks (SURVEY.md §2.4 / §5):
``DisableAugmentationHook`` (switch augmentation off for the last epochs,
``core/hook/fsd_hooks.py:7-54``), ``EnableFSDDetectionHook(Iter)`` (phase in
the detection losses after a segmentation warm-up, ``:56-90``) and
``EnableAddableTrainingHook`` (gate an extra training mode at a step,
``core/hook/occ_hooks.py:7-38``). mmcv's hook registry becomes a plain list
of ``(step, callback)`` triggers the trainer walks each step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass
class StepHook:
    at_step: int
    fn: Callable[[], None]
    name: str = "hook"
    fired: bool = False


@dataclass
class HookList:
    hooks: list = field(default_factory=list)

    def add(self, at_step: int, fn: Callable[[], None], name: str = "hook"):
        self.hooks.append(StepHook(at_step, fn, name))
        return self

    def on_step(self, step: int):
        for h in self.hooks:
            if not h.fired and step >= h.at_step:
                h.fn()
                h.fired = True


def disable_augmentation_hook(dataset, at_step: int) -> StepHook:
    """Turn dataset augmentation off from ``at_step`` on
    (DisableAugmentationHook: num_last_epochs -> step threshold)."""
    def fn():
        dataset.augment = False
    return StepHook(at_step, fn, "disable_augmentation")


def loss_weight_warmup(enable_step: int):
    """Returns weight(step): 0 before ``enable_step``, 1 after — the
    EnableFSDDetectionHookIter pattern for phasing in detection losses."""
    def weight(step: int) -> float:
        return 0.0 if step < enable_step else 1.0
    return weight
