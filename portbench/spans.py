"""The per-layer metrics read from the program's own tracer
(``objectcentricocccompletion_torch/utils/profiling.py``): its spans'
stream time and its counters over the traced calls. A program without the
tracer, or without the span or counter, gives None."""
from __future__ import annotations


def snapshot() -> dict | None:
    """The program's records of the traced stretch, or None where it keeps
    none."""
    try:
        from objectcentricocccompletion_torch.utils.profiling import \
            snapshot as program_snapshot
    except ImportError:
        return None
    return program_snapshot()


def span_ms(name: str, ctx) -> float | None:
    """The span ``name``'s stream time per traced call (step), in ms: from
    its entry event to its exit event, over all its instances."""
    snap = snapshot()
    found = snap and snap["spans"].get(name)
    if not found:
        return None
    return found["stream_ms"] / ctx.calls


def fill(useful: str, slots: str) -> float | None:
    """100 x the counter ``useful`` over the counter ``slots``, in %."""
    snap = snapshot()
    counters = snap["counters"] if snap else {}
    if useful not in counters or not counters.get(slots):
        return None
    return 100.0 * counters[useful] / counters[slots]
