"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace T

from the root of a checkout (T is 0 or 1). The cell is an entry of
``BENCHMARK.json``; the run needs as many CUDA cards as the cell asks for
and fails without them. Its last line on standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last the numbers compared with
the reference beside their limits under ``checks``); the same numbers end
standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
