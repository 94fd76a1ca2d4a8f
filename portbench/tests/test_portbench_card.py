"""The checks of ``correct`` on the card, at each cell's own size: the
port's readings over a dozen seeds (the lower readings of the limits), and
the control, the port at bfloat16, and each training mode's ``HALF_FAULT``,
which must come out not correct (the upper readings). The cells are those
of ``BENCHMARK.json``, each read after its mode's ``CARD_SECONDS``. Run on
a machine with the card:

    python -m pytest portbench/tests/test_portbench_card.py -m card -s

Each run prints one ``READING`` line per seed with the numbers compared.
"""
from __future__ import annotations

import json
import time

import pytest

from portbench import harness

pytestmark = pytest.mark.card

READ_SEEDS = (2654435761, 2246822519, 3266489917, 668265263, 374761393,
              2870177450, 1103515245, 12345678901, 3735928559, 4294967311,
              2147483659, 987654321013)
CONTROL_SEEDS = (1597334677, 3812015801, 2971215073)


def cells(bench: dict | None = None) -> list:
    """The cells of ``bench`` (``BENCHMARK.json``)."""
    bench = bench or harness.load_json(harness.ROOT / "BENCHMARK.json")
    return [w["name"] for w in bench["workloads"]]


def mode_of(cell: str, bench: dict | None = None):
    return harness.mode_module(harness.load_cell(cell, bench)["mix"])


def seconds(cell: str, bench: dict | None = None) -> float:
    """The cell's short window at its own load: long enough for the
    check's sample (its mode's ``CARD_SECONDS``)."""
    return mode_of(cell, bench).CARD_SECONDS


def fault_cases(bench: dict | None = None) -> list:
    """``(cell, fault)`` for each cell whose mode names a ``HALF_FAULT``:
    the fault that reads highest short of the control."""
    modes = {c: mode_of(c, bench) for c in cells(bench)}
    return [(c, m.HALF_FAULT) for c, m in modes.items()
            if getattr(m, "HALF_FAULT", None)]


CELLS = cells()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def _readings(cell: str, seeds, device, dtype=None, fault=None) -> list:
    import torch
    spec = harness.load_cell(cell)
    out = []
    for seed in seeds:
        r = harness.run_cell(spec, seed, seconds(cell), False, device,
                             time.perf_counter(), dtype=dtype, fault=fault)
        readings = r.pop("readings")
        row = dict(cell=cell, seed=seed, dtype=dtype or "config", fault=fault,
                   correct=r["correct"],
                   checks=readings)
        print("READING", json.dumps(row), flush=True)
        out.append(row)
        torch.cuda.empty_cache()
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_program_readings(card, cell):
    rows = _readings(cell, READ_SEEDS, card)
    assert all(r["correct"] for r in rows)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(card, cell):
    rows = _readings(cell, CONTROL_SEEDS, card, dtype="bfloat16")
    assert not any(r["correct"] for r in rows)


@pytest.mark.parametrize("cell,fault", fault_cases())
def test_fault_fails(card, cell, fault):
    """A training cell's fault that reads highest short of the control
    (``ococcnet.train``: half of each batch left out, the loss's means
    taken over the rest)."""
    rows = _readings(cell, CONTROL_SEEDS, card, fault=fault)
    assert not any(r["correct"] for r in rows)
