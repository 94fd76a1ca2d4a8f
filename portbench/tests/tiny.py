"""The benchmark's cells cut to a size the CPU tests hold: the port's tiny
configurations (the OcOccNet one with a packed budget that binds) and small
pools, every other setting the cell's own."""
from __future__ import annotations

import dataclasses
import json

from portbench import harness

# the LiDAR scene cut to the tiny grid (19.2 m across, 2,048 slots)
SCENE = dict(lidar=dict(beams=16, azimuths=120, max_range_m=13.0),
             walls=dict(sectors=12, range_m=[5.0, 9.0]),
             objects=dict(counts=[3, 1, 2], range_m=[2.0, 8.0]))
MIXES = {
    "refine": dict(tracklets=6, min_len=3, max_len=16, buckets=[8, 16],
                   frames_per_call=32, queries_per_frame=32,
                   full_range_m=40.0, check_calls=3, trace_calls=2),
    "detect": dict(frames=3, check_frames=2, trace_calls=2),
    "train": dict(batches=4, batch=2, length=8, full_range_m=40.0,
                  log_interval=2, trace_calls=2),
}


def ococcnet_config() -> dict:
    from objectcentricocccompletion_torch.configs.ococcnet_config import \
        tiny_config
    cfg = dataclasses.asdict(tiny_config())
    # 16 slots per frame in blocks of 16: frames over it are cut
    cfg.update(packed_point_budget=128, packed_quantum=16)
    return cfg


def sst_config() -> dict:
    """The port's tiny detector with the cell's anchors and classes."""
    from objectcentricocccompletion_torch.models.sst_detector import \
        tiny_sst_detector_config
    cfg = json.loads(json.dumps(dataclasses.asdict(
        tiny_sst_detector_config())))
    full = harness.load_json(harness.HERE / "configs" / "sst.json")["config"]
    cfg.update(anchors=full["anchors"], num_classes=full["num_classes"])
    return cfg


def cell(name: str) -> dict:
    """``harness.load_cell(name)`` at the tiny size."""
    spec = harness.load_cell(name)
    cfg = ococcnet_config() if spec["config"]["reference"] == "ococcnet" \
        else sst_config()
    spec["config"] = dict(spec["config"], config=cfg)
    mix = dict(spec["mix"], **MIXES[spec["mix"]["mode"]])
    for k, v in SCENE.items():
        if k in mix:
            mix[k] = dict(mix[k], **v)
    spec["mix"] = mix
    return spec
