"""A new configuration, mode and cell need only new files: every test that
goes over the cells finds them by the names ``BENCHMARK.json`` gives, and
each mode and configuration carries what those tests look up."""
from __future__ import annotations

import importlib
import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import test_portbench_faults as faults

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
MODES = sorted(p.stem for p in (harness.HERE / "modes").glob("*.py")
               if p.stem != "__init__")


@pytest.mark.parametrize("mode", MODES)
def test_every_mode_declares_its_parts(mode):
    mod = importlib.import_module(f"portbench.modes.{mode}")
    assert isinstance(mod.FAULTS, tuple) and all(
        isinstance(f, str) for f in mod.FAULTS)
    assert isinstance(mod.TINY_MIX, dict)
    assert isinstance(mod.CARD_SECONDS, float) and mod.CARD_SECONDS > 0
    assert getattr(mod, "HALF_FAULT", None) in (None,) + mod.FAULTS


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_has_a_tiny_configuration(config):
    mod = importlib.import_module(f"portbench.tests.tiny_{config}")
    assert isinstance(mod.config(), dict)


TOY_MODE = '''"""A mode no cell of the benchmark has."""
FAULTS = ("answer", "unchanged")
HALF_FAULT = "answer"
TINY_MIX = dict(items=2)
CARD_SECONDS = 3.0
'''
TOY_TINY = '''"""The toy configuration at the tiny size."""


def config():
    return {"width": 4}
'''
PROBE = '''
import json
import portbench
from portbench.tests import test_portbench_card as card
from portbench.tests import test_portbench_faults as faults
from portbench.tests import tiny
spec = tiny.cell("toy.run")
print(json.dumps(dict(
    package=portbench.__file__, config=spec["config"]["config"],
    mix=spec["mix"], cases=faults.CASES, cells=card.CELLS,
    seconds=card.seconds("toy.run"), card_faults=card.fault_cases())))
'''


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A copy of the benchmark given a new configuration, mix, mode, limits
    and tiny configuration, and a cell of them appended to its
    ``BENCHMARK.json``: the tiny cell, the faults' cases and the card
    test's cells and faults take it up, no file of the copy edited."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    (pb / "modes" / "toy.py").write_text(TOY_MODE)
    (pb / "tests" / "tiny_toy.py").write_text(TOY_TINY)
    (pb / "configs" / "toy.json").write_text(json.dumps(dict(
        name="toy", reference="toy", reduced=[], config={"width": 64})))
    (pb / "traffic" / "toy.json").write_text(json.dumps(dict(
        mode="toy", items=100, trace_calls=3)))
    (pb / "limits" / "toy.run.json").write_text(json.dumps({"gap": 1e-3}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(name="toy", source="https://example.org",
                                 file="portbench/configs/toy.json",
                                 reduced=[], why="a toy"))
    bench["workloads"].append(dict(name="toy.run", config="toy",
                                   traffic="toy", chips=1, why="a toy"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    r = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.splitlines()[-1])
    assert got["package"].startswith(str(tmp_path))
    assert got["config"] == {"width": 4}
    assert got["mix"] == dict(mode="toy", items=2, trace_calls=3)
    cases = [tuple(c) for c in got["cases"]]
    assert cases[-3:] == [("toy.run", "control"), ("toy.run", "answer"),
                          ("toy.run", "unchanged")]
    assert len(cases) == len(faults.CASES) + 3
    assert got["cells"] == [w["name"] for w in BENCH["workloads"]] + [
        "toy.run"]
    assert got["seconds"] == 3.0
    assert ["toy.run", "answer"] in got["card_faults"]
