"""What a run promises, checked on the CPU: no card, no result; the result
line's shape at the tiny size; the cells, files and readers that
``BENCHMARK.json`` names."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
import types

import pytest

from portbench import harness
from portbench.tests import tiny

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _cli(cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    r = _cli(harness.ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA card" in r.stderr


def test_benchmark_alone_fails(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's files
    runs nothing."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert harness.load_json(harness.ROOT / c["file"])["reduced"] == \
            c["reduced"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get(
            "workloads", CELLS))
        harness.reader(m["name"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        spec = harness.load_cell(w["name"])
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        assert spec["limits"]
        harness.mode_module(spec["mix"])


def test_forbidden_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "flax.linen",
                        types.ModuleType("flax.linen"))
    assert "flax" in harness.forbidden_modules()
    assert "objectcentricocccompletion_torch" not in \
        harness.forbidden_modules()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (False, True))
def test_result_line(cell, trace):
    spec = tiny.cell(cell)
    r = harness.run_cell(spec, 2 ** 34 + 3, 0.3, trace, "cpu",
                         time.perf_counter())
    r.pop("readings")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(spec["limits"])
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert r["device"]["window_s"] > 0
        assert set(r["metrics"]) <= {m["name"] for m in spec["per_layer"]}
        for key in ("device_ops", "idle_gaps"):
            assert len(r["breakdown"][key]) <= harness.TOP_N
    else:
        assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    json.loads(json.dumps(r, allow_nan=False))


def test_idle_share_reads_the_untraced_wall():
    """The card's busy time per traced call against the untraced window's
    wall per call: a traced wall the profiler stretched changes nothing."""
    read = harness.reader("idle_share.train")
    ctx = types.SimpleNamespace(device_events=[(0.0, 1.0, "k")], calls=3,
                                busy_s=0.531, window_s=1.06,
                                wall_per_call=0.236)
    assert abs(read(ctx) - 100 * (1 - 0.177 / 0.236)) < 1e-9
    ctx.window_s = 2.0
    assert abs(read(ctx) - 100 * (1 - 0.177 / 0.236)) < 1e-9
    ctx.device_events = []
    assert read(ctx) is None
