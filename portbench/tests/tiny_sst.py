"""The ``sst`` configuration at the CPU tests' size."""
from __future__ import annotations

import dataclasses
import json

from portbench import harness


def config() -> dict:
    """The port's tiny detector with the cell's anchors and classes."""
    from objectcentricocccompletion_torch.models.sst_detector import \
        tiny_sst_detector_config
    cfg = json.loads(json.dumps(dataclasses.asdict(
        tiny_sst_detector_config())))
    full = harness.load_json(harness.HERE / "configs" / "sst.json")["config"]
    cfg.update(anchors=full["anchors"], num_classes=full["num_classes"])
    return cfg
