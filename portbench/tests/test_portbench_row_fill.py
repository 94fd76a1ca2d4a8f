"""``row_fill.detect`` read from the program's tracer: the counters
``sst.rows`` / ``sst.row_slots``, None without them (as on a program older
than them), and the program's rows against the plain reference's own
voxels."""
from __future__ import annotations

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from portbench.modes import detect
from portbench.reference import sst as ref
from portbench.tests import tiny


def _snapshot(counters):
    return lambda: dict(spans={}, counters=counters, records=[])


def test_reader(monkeypatch):
    from objectcentricocccompletion_torch.utils import profiling
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "row_fill.detect"]
    assert entry["layer"] == "SST blocks" and entry["unit"] == "%"
    read = harness.reader("row_fill.detect")
    ctx = types.SimpleNamespace(calls=4)
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert read(ctx) is None
    # the windows' counters alone, as a program without the rows gives
    monkeypatch.setattr(profiling, "snapshot", _snapshot(
        {"sst.tokens": 30, "sst.token_slots": 120}))
    assert read(ctx) is None
    monkeypatch.setattr(profiling, "snapshot", _snapshot(
        {"sst.rows": 13, "sst.row_slots": 0}))
    assert read(ctx) is None
    monkeypatch.setattr(profiling, "snapshot", _snapshot(
        {"sst.rows": 130, "sst.row_slots": 200}))
    assert read(ctx) == pytest.approx(65.0)
    monkeypatch.delattr(profiling, "snapshot")
    assert read(ctx) is None


def test_rows_match_the_reference():
    """Over a traced frame the program's ``sst.rows`` is the reference's
    voxel count, once a layer, and ``sst.row_slots`` ``max_voxels`` a
    layer."""
    from objectcentricocccompletion_torch.utils import profiling
    spec = tiny.cell("sst.detect")
    cfg = spec["config"]["config"]
    mode = detect.Mode(spec["config"], spec["mix"], 2 ** 33 + 7, "cpu")
    pts, msk = mode.host[0]
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            mode.model.predict(pts, msk, mode.max_out)
    counters = profiling.snapshot()["counters"]
    layers = 2 * cfg["sst"]["num_blocks"]
    want = ref.frame_work(cfg, pts, msk)["voxels"]
    assert counters["sst.rows"] == layers * want
    assert counters["sst.row_slots"] == layers * cfg["sst"]["max_voxels"]
    assert 0 < want <= cfg["sst"]["max_voxels"]
