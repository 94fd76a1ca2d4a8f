"""The import boundary of the benchmark: no module under ``portbench/``
imports JAX or the JAX package (or the JAX package's benchmark), and no
reference imports the port. Compared by each import's top-level name (the
part before the first dot), whole: the port's name begins with the JAX
package's."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "objectcentricocccompletion_tpu",
             "bench", "benchmarks"}
PORT = "objectcentricocccompletion_torch"
MODULES = sorted(ROOT.rglob("*.py"))
# the JAX package's result files' prefix, which nothing here reads
RESULTS = "BENCH" + "_"


def imports(path: Path) -> list:
    """``(top-level name, level)`` of every import in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
    return out


def test_modules_found():
    assert len(MODULES) > 10
    assert ROOT / "reference" / "ococcnet.py" in MODULES


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(
    ROOT)))
def test_no_jax(path):
    names = {n for n, level in imports(path) if level == 0}
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert RESULTS not in path.read_text()


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    """A reference imports neither the port nor any other part of the
    benchmark (which builds the port)."""
    found = imports(path)
    assert all(n != PORT for n, _ in found)
    assert all(level == 0 for _, level in found), found


def test_prefix_is_not_enough():
    """The rule compares whole top-level names: the port's name starts
    with the JAX package's and is allowed."""
    assert PORT.startswith("objectcentricocccompletion")
    assert PORT not in FORBIDDEN
