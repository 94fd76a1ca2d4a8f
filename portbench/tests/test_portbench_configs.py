"""Each configuration file holds its source's values as the port states
them, apart from the keys it lists under ``reduced``: OcOccNet's as
``OcOccNetConfig()``, SST's as ``SSTDetectorConfig()`` with the three Waymo
classes of ``sst_waymoD5_1x_3class_8heads_v2.py``."""
from __future__ import annotations

import dataclasses
import json

from portbench import harness


def _plain(x):
    return json.loads(json.dumps(x))


def _differ(file_cfg: dict, source: dict) -> set:
    return {k for k in set(file_cfg) | set(source)
            if _plain(file_cfg.get(k)) != _plain(source.get(k))}


def test_ococcnet_is_the_published_config():
    from objectcentricocccompletion_torch.configs.ococcnet_config import \
        OcOccNetConfig
    f = harness.load_json(harness.HERE / "configs" / "ococcnet.json")
    source = dataclasses.asdict(OcOccNetConfig())
    assert _differ(f["config"], source) <= set(f["reduced"])


def test_sst_is_the_published_three_class_config():
    from objectcentricocccompletion_torch.models.anchor_head import \
        waymo_3class_anchor_config
    from objectcentricocccompletion_torch.models.sst_detector import \
        SSTDetectorConfig
    f = harness.load_json(harness.HERE / "configs" / "sst.json")
    source = dataclasses.asdict(SSTDetectorConfig(
        anchors=waymo_3class_anchor_config(), num_classes=3))
    assert _differ(f["config"], source) <= set(f["reduced"])
    assert len(f["config"]["anchors"]["sizes"]) == \
        f["config"]["num_classes"] == 3
