"""``correct`` comes out false on a broken timed path: the control (the
port at bfloat16) and each fault the cell's mode declares (``FAULTS``), at
the tiny size on the CPU, everything else as a run drives it. One chip, so
no exchange between chips to leave out."""
from __future__ import annotations

import time

import pytest

from portbench import harness
from portbench.tests import tiny


def cases(bench: dict | None = None) -> list:
    """``(cell, fault)`` for every cell of ``bench`` (``BENCHMARK.json``):
    the control, then each of its mode's ``FAULTS``."""
    bench = bench or harness.load_json(harness.ROOT / "BENCHMARK.json")
    return [(w["name"], f) for w in bench["workloads"]
            for f in ("control",) + harness.mode_module(
                harness.load_cell(w["name"], bench)["mix"]).FAULTS]


CASES = cases()


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_path_is_not_correct(cell, fault):
    spec = tiny.cell(cell)
    dtype = "bfloat16" if fault == "control" else None
    r = harness.run_cell(spec, 31337, 0.2, False, "cpu", time.perf_counter(),
                         dtype=dtype,
                         fault=None if fault == "control" else fault)
    assert r["correct"] is False, r["checks"]
