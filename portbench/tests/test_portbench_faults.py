"""``correct`` comes out false on a broken timed path: the control (the
port at bfloat16) and each fault the cell can have, at the tiny size on
the CPU, everything else as a run drives it. One chip, so no exchange
between chips to leave out."""
from __future__ import annotations

import time

import pytest

from portbench import harness
from portbench.tests import tiny

FAULTS = {"refine": ("answer",), "detect": ("answer",),
          "train": ("unchanged", "half_batch")}
CASES = [(w["name"], f) for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]
    for f in ("control",) + FAULTS[harness.load_cell(w["name"])["mix"][
        "mode"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_path_is_not_correct(cell, fault):
    spec = tiny.cell(cell)
    dtype = "bfloat16" if fault == "control" else None
    r = harness.run_cell(spec, 31337, 0.2, False, "cpu", time.perf_counter(),
                         dtype=dtype,
                         fault=None if fault == "control" else fault)
    assert r["correct"] is False, r["checks"]
