"""The discrete routes of a backward, recorded on one run and fed to another.

A ReLU passes its gradient where its input is positive; a max reduction
passes it to the rows that attain the maximum (split evenly among ties).
Where an input lies within a rounding step of 0, or of another row's value,
two devices may route the same gradient differently, and their gradients
then differ by the whole routed amount. A caller that holds one device's
backward against another's records the first run's routes and feeds them
to the second, as it feeds the grouping: ``with Routes() as routes:``
records them (``routes.masks``, on the run's device), ``with
Routes(masks):`` feeds them. Only inputs that take a gradient are routed;
with no ``Routes`` active each op is its plain self. The picks of
``ops/pointnet.py`` (sample and neighbour indices, ball memberships) go
through the active ``Routes`` too, with or without a gradient."""
from __future__ import annotations

from typing import Callable, Sequence

import torch


class Routes:
    """The routes of the ops that ask :func:`taking`, in call order.
    ``flips`` counts the fed elements that differ from the run's own route,
    ``flipped`` lists ``(call, kind, shape, count)`` of each op that has
    some, ``fed`` counts the elements fed."""

    active: "Routes | None" = None

    def __init__(self, masks: Sequence[torch.Tensor] | None = None):
        self.feeding = masks is not None
        self.masks = list(masks) if self.feeding else []
        self.used = self.flips = self.fed = 0
        self.flipped: list[tuple[int, str, tuple, int]] = []

    def __enter__(self) -> "Routes":
        Routes.active = self
        return self

    def __exit__(self, kind, *exc):
        Routes.active = None
        if self.feeding and kind is None and self.used != len(self.masks):
            raise RuntimeError(f"{len(self.masks)} route masks given, "
                               f"{self.used} used")

    def take(self, kind: str, own: torch.Tensor) -> torch.Tensor:
        """This call's route: ``own`` (a boolean mask, or a pick's
        indices) where recording, else the fed one."""
        if not self.feeding:
            self.masks.append(own)
            return own
        if self.used == len(self.masks):
            raise RuntimeError(f"only {len(self.masks)} route masks")
        fed = self.masks[self.used].to(own.device)
        if fed.shape != own.shape:
            raise RuntimeError(f"route {self.used} ({kind}): a mask of "
                               f"shape {tuple(fed.shape)} for "
                               f"{tuple(own.shape)}")
        count = int((fed != own).sum())
        if count:
            self.flipped.append((self.used, kind, tuple(own.shape), count))
        self.used += 1
        self.fed += fed.numel()
        self.flips += count
        return fed


def taking(x: torch.Tensor) -> Routes | None:
    """The active :class:`Routes` where ``x`` takes a gradient, else
    None."""
    routes = Routes.active
    return routes if routes is not None and x.requires_grad else None


def relu(x: torch.Tensor) -> torch.Tensor:
    """``torch.relu``, routed: a fed ReLU is ``x * mask``, which differs
    from ``relu(x)`` only where the signs differ, by that input."""
    routes = taking(x)
    if routes is None:
        return torch.relu(x)
    mask = routes.take("relu", x.detach() > 0)
    return x * mask.to(x.dtype) if routes.feeding else torch.relu(x)


def fed_max(out: torch.Tensor, x: torch.Tensor, winners: torch.Tensor,
            reduce: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``out``, a max reduction of ``x``, with its gradient sent to the
    rows of ``winners`` (a mask like ``x``), split evenly among them;
    ``reduce`` sums a tensor like ``x`` into ``out``'s rows. The value is
    ``out``'s: the routed term is a sum of exact zeros."""
    n = reduce(winners.to(x.dtype)).clamp(min=1)
    return out.detach() + reduce((x - x.detach()) * winners) / n
