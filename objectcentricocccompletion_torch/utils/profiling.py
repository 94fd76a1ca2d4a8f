"""Tracing of the program (counterpart of the JAX package's
``utils/profiling.py``): spans and counters at its layer boundaries, kept
while a ``torch.profiler`` session records, the kernels' launch tallies,
and :func:`trace`, which records a session into a Chrome / Perfetto file.

- :func:`span` names a stretch of a call. With no profiler recording it is
  one check of a flag and a shared null context. While one records, it is a
  ``record_function`` (so the span sits in the profiler's trace beside the
  kernels) and a record in memory: name, parent span, call id, host start
  and end, and a timing CUDA event on the current stream at entry and exit.
- :func:`count` adds a value to a counter at the same boundaries, while a
  profiler records. A tensor is kept as it is and summed only when the
  records are read: the traced calls carry no extra kernel and no sync.
- :func:`tally` counts on every call, profiler or not (the hand-written
  kernels' launches, ``TALLIES``); while a profiler records, each one is
  also a :func:`count`.
- :func:`snapshot` reads the records of the newest session: per span name
  its instances, host ms, stream ms (entry event to exit event) and self
  stream ms (less the part its child spans cover), and each counter's
  total. Each new profiler session starts the records afresh.

Without CUDA (on the CPU) a span's stream time is its host time.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity

_NULL = contextlib.nullcontext()
# the kernels' launch counts by key, whatever the profiler does
TALLIES: collections.defaultdict = collections.defaultdict(
    collections.Counter)


class _Records:
    """What the current profiler session has recorded."""

    def __init__(self):
        self.reset()

    def reset(self):
        # each: [name, parent record or None, call id, host start ns,
        # host end ns, start event, end event]
        self.spans: list = []
        self.counts = collections.defaultdict(list)
        self.calls = 0
        self.cuda: bool | None = None     # decided at the session's first span


_RECORDS = _Records()
_LOCAL = threading.local()                # this thread's open spans


def _on_profiler_start(start=_autograd_profiler._run_on_profiler_start):
    _RECORDS.reset()
    start()


# every profiler session (torch.profiler, the autograd profiler) calls this
# hook of torch's as it starts
if getattr(_autograd_profiler._run_on_profiler_start, "__module__",
           None) != __name__:
    _autograd_profiler._run_on_profiler_start = _on_profiler_start


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str):
        self.rec = [name, None, 0, 0, 0, None, None]
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        rec, recs = self.rec, _RECORDS
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        if stack:
            rec[1], rec[2] = stack[-1], stack[-1][2]
        else:
            recs.calls += 1
            rec[2] = recs.calls
        if recs.cuda is None:
            recs.cuda = torch.cuda.is_initialized()
        stack.append(rec)
        recs.spans.append(rec)
        rec[3] = time.perf_counter_ns()
        self.rf.__enter__()
        if recs.cuda:
            rec[5] = _event()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec[5] is not None:
            rec[6] = _event()
        self.rf.__exit__(*exc)
        rec[4] = time.perf_counter_ns()
        _LOCAL.stack.pop()
        return False


def span(name: str):
    """A context manager naming a stretch of the program; recorded only
    while a ``torch.profiler`` session records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor summed when read) to the counter
    ``name``, while a profiler session records."""
    if _autograd_profiler._is_profiler_enabled:
        _RECORDS.counts[name].append(value)


def tally(name: str, key) -> None:
    """One more ``key`` in ``TALLIES[name]``, profiler or not; while a
    session records, also ``count(name, 1)``."""
    TALLIES[name][key] += 1
    if _autograd_profiler._is_profiler_enabled:
        _RECORDS.counts[name].append(1)


def union_length(intervals: list) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def snapshot() -> dict:
    """The newest session's records: ``spans`` (per name: ``instances``,
    ``host_ms``, ``stream_ms``, ``self_ms``, summed over instances),
    ``counters`` (per name, the total) and ``records`` (per finished span
    in order of entry: ``name``, ``parent`` (its index or None), ``call``,
    ``start_ms``, ``end_ms`` on the stream's clock from the first span's
    entry)."""
    recs = [r for r in _RECORDS.spans if r[4]]
    rows = []
    if recs:
        if recs[0][5] is not None:
            ref = recs[0][5]
            for r in recs:
                r[6].synchronize()
            times = [(ref.elapsed_time(r[5]), ref.elapsed_time(r[6]))
                     for r in recs]
        else:
            t0 = recs[0][3]
            times = [((r[3] - t0) * 1e-6, (r[4] - t0) * 1e-6) for r in recs]
        index = {id(r): i for i, r in enumerate(recs)}
        rows = [dict(name=r[0], parent=index.get(id(r[1])), call=r[2],
                     start_ms=s, end_ms=e, host_ms=(r[4] - r[3]) * 1e-6)
                for r, (s, e) in zip(recs, times)]
    children = collections.defaultdict(list)
    for row in rows:
        if row["parent"] is not None:
            children[row["parent"]].append(row)
    spans: dict = {}
    for i, row in enumerate(rows):
        s, e = row["start_ms"], row["end_ms"]
        inner = union_length([(max(c["start_ms"], s),
                               min(c["end_ms"], e)) for c in children[i]
                              if c["end_ms"] > s and c["start_ms"] < e])
        agg = spans.setdefault(row["name"], dict(
            instances=0, host_ms=0.0, stream_ms=0.0, self_ms=0.0))
        agg["instances"] += 1
        agg["host_ms"] += row.pop("host_ms")
        agg["stream_ms"] += e - s
        agg["self_ms"] += e - s - inner
    counters = {name: sum(int(v.sum()) if isinstance(v, torch.Tensor) else v
                          for v in vals)
                for name, vals in _RECORDS.counts.items()}
    return dict(spans=spans, counters=counters, records=rows)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (the host, and the
    card where there is one) and write it to ``log_dir/trace.json`` (open it
    in Perfetto or ``chrome://tracing``). Yields the profiler (its
    ``key_averages()`` sum the operators), or None where it cannot start:
    then the block runs untraced, as in the JAX package. The program's
    spans are in the trace, and :func:`snapshot` reads them afterwards.

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
