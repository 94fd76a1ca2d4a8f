"""The per-layer metrics read from the program's tracer: None without the
span or counter (or without the tracer, as on a program older than it),
each per traced call, and the program's token counter against the plain
reference's own windowing."""
from __future__ import annotations

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from portbench.modes import detect
from portbench.reference import sst as ref
from portbench.tests import tiny

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def source(metric: str):
    """The span, or the ``(useful, slots)`` counters, that the metric's
    reader takes from the program's tracer (its ``SOURCE``); None for a
    reader of anything else."""
    return getattr(harness.reader_module(metric), "SOURCE", None)


METRICS = [m["name"] for m in BENCH["per_layer"] if source(m["name"])]


def test_every_source_has_a_metric():
    """Every reader that takes the program's spans or counters declares
    what it takes, and each of them reads a metric of ``BENCHMARK.json``."""
    tracer = {p.stem for p in (harness.HERE / "metrics").glob("*.py")
              if "portbench.spans" in p.read_text()}
    declared = {p.stem for p in (harness.HERE / "metrics").glob("*.py")
                if source(p.stem)}
    assert tracer == declared and declared
    assert {m.split(".")[0] for m in METRICS} == declared


def _snapshot(spans=None, counters=None):
    return lambda: dict(spans=spans or {}, counters=counters or {},
                        records=[])


@pytest.mark.parametrize("metric", METRICS)
def test_reader(metric, monkeypatch):
    from objectcentricocccompletion_torch.utils import profiling
    read = harness.reader(metric)
    ctx = types.SimpleNamespace(calls=4)
    src = source(metric)
    # a session that recorded nothing
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert read(ctx) is None
    if isinstance(src, str):
        monkeypatch.setattr(profiling, "snapshot", _snapshot(
            {"other": dict(instances=4, stream_ms=9.0)}))
        assert read(ctx) is None
        monkeypatch.setattr(profiling, "snapshot", _snapshot(
            {src: dict(instances=8, host_ms=1.0, stream_ms=10.0,
                       self_ms=2.0)}))
        assert read(ctx) == pytest.approx(2.5)
    else:
        monkeypatch.setattr(profiling, "snapshot", _snapshot(
            counters={src[0]: 3}))
        assert read(ctx) is None
        monkeypatch.setattr(profiling, "snapshot", _snapshot(
            counters={src[0]: 30, src[1]: 120}))
        assert read(ctx) == pytest.approx(25.0)
    # a program without the tracer
    monkeypatch.delattr(profiling, "snapshot")
    assert read(ctx) is None


def test_tokens_match_the_reference():
    """The program's ``sst.tokens`` over a traced frame is the reference's
    live-window token count summed over the layers, as ``modes/detect.py``
    takes it for the attention bound."""
    from objectcentricocccompletion_torch.utils import profiling
    spec = tiny.cell("sst.detect")
    mode = detect.Mode(spec["config"], spec["mix"], 2 ** 33 + 5, "cpu")
    pts, msk = mode.host[0]
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            mode.model.predict(pts, msk, mode.max_out)
    counters = profiling.snapshot()["counters"]
    want = ref.frame_work(spec["config"]["config"], pts, msk)
    assert counters["sst.tokens"] == sum(sum(t) for t in
                                         want["window_tokens"])
    assert 0 < counters["sst.tokens"] < counters["sst.token_slots"]
