"""The benchmark's cells cut to a size the CPU tests hold, found by the
names ``BENCHMARK.json`` gives: the configuration's tiny counterpart
(``tests/tiny_<config>.py``'s ``config()``), the mix cut by its mode's
``TINY_MIX`` (``modes/<mode>.py``) and the LiDAR scene cut to the tiny
grid; every other setting the cell's own."""
from __future__ import annotations

import importlib

from portbench import harness

# the LiDAR scene cut to the tiny grid (19.2 m across, 2,048 slots)
SCENE = dict(lidar=dict(beams=16, azimuths=120, max_range_m=13.0),
             walls=dict(sectors=12, range_m=[5.0, 9.0]),
             objects=dict(counts=[3, 1, 2], range_m=[2.0, 8.0]))


def cell(name: str, bench: dict | None = None) -> dict:
    """``harness.load_cell(name)`` at the tiny size."""
    spec = harness.load_cell(name, bench)
    cfg = importlib.import_module(
        f"portbench.tests.tiny_{spec['config']['name']}").config()
    spec["config"] = dict(spec["config"], config=cfg)
    mix = dict(spec["mix"], **harness.mode_module(spec["mix"]).TINY_MIX)
    for k, v in SCENE.items():
        if k in mix:
            mix[k] = dict(mix[k], **v)
    spec["mix"] = mix
    return spec
