"""The ``ococcnet`` configuration at the CPU tests' size."""
from __future__ import annotations

import dataclasses


def config() -> dict:
    """The port's tiny OcOccNet with a packed budget that binds."""
    from objectcentricocccompletion_torch.configs.ococcnet_config import \
        tiny_config
    cfg = dataclasses.asdict(tiny_config())
    # 16 slots per frame in blocks of 16: frames over it are cut
    cfg.update(packed_point_budget=128, packed_quantum=16)
    return cfg
