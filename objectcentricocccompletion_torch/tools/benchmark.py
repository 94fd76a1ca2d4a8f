"""Inference-latency benchmark of the port (counterpart of the JAX
repository's ``tools/benchmark.py``; the ``sst`` family so far).

    python -m objectcentricocccompletion_torch.tools.benchmark sst \\
        --frames 20 --dtype bfloat16

Builds the full-width ``SSTDetector(SSTDetectorConfig())`` with weights
drawn from a seeded ``torch.Generator`` (no checkpoint is needed), runs
``predict`` on a seeded synthetic frame after warm-up, and prints one JSON
line: the per-frame latency (host clock around work that ends in a device
synchronise), the device, and the card's name and power limit.

``--profile N`` also traces N more frames with ``torch.profiler``, prints
the operators that take the most device time, and adds the device's busy
time per frame and busy share (kernel time over wall time) to the line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from ..data.synthetic import synth_frame
from ..evalx.detector_eval import make_predict_fn
from ..models.sst_detector import SSTDetector, SSTDetectorConfig
from ..utils.device import card_info, resolve_device


def sst_config(dtype: str = "bfloat16",
               cfg: SSTDetectorConfig | None = None) -> SSTDetectorConfig:
    cfg = cfg or SSTDetectorConfig()
    return dataclasses.replace(
        cfg, sst=dataclasses.replace(cfg.sst, compute_dtype=dtype))


def build_sst(cfg: SSTDetectorConfig, device="cuda", seed: int = 0
              ) -> SSTDetector:
    gen = torch.Generator().manual_seed(seed)
    return SSTDetector(cfg, device=device, generator=gen).eval()


def frame_tensors(cfg: SSTDetectorConfig, device, num_real: int = 150000,
                  seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """A ``synth_frame`` at the config's point budget, on ``device``."""
    points, mask, *_ = synth_frame(cfg.sst.max_points, cfg.sst.pc_range,
                                   num_real=num_real, seed=seed)
    dev = resolve_device(device)
    return torch.from_numpy(points).to(dev), torch.from_numpy(mask).to(dev)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_frames(predict, points, mask, frames: int, warmup: int = 2
                ) -> list[float]:
    """Milliseconds of each of ``frames`` predict calls after ``warmup``
    untimed ones; each call ends in a device synchronise."""
    dev = points.device
    for _ in range(warmup):
        predict(points, mask)
    _sync(dev)
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        predict(points, mask)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def profile_frames(predict, points, mask, frames: int,
                   row_limit: int = 25) -> dict:
    """Trace ``frames`` predict calls on the card; print the operators by
    device time and return the device busy time per frame and busy share
    (summed kernel and copy time over the traced wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = points.device
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            predict(points, mask)
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    print(avgs.table(sort_by="self_device_time_total", row_limit=row_limit,
                     max_name_column_width=60))
    # kernels and copies only: an operator's row repeats its kernels' time
    busy_ms = sum(e.self_device_time_total for e in avgs
                  if e.device_type == DeviceType.CUDA) / 1e3
    return {"device_busy_ms_per_frame": busy_ms / frames,
            "device_busy_share": busy_ms / wall_ms,
            "profiled_wall_ms_per_frame": wall_ms / frames}


def bench_sst(frames: int, dtype: str = "bfloat16", device="cuda",
              seed: int = 0, num_real: int = 150000,
              profile_n: int = 0) -> dict:
    dev = resolve_device(device)
    cfg = sst_config(dtype)
    model = build_sst(cfg, dev, seed)
    points, mask = frame_tensors(cfg, dev, num_real, seed)
    predict = make_predict_fn(model, "sst")
    times = time_frames(predict, points, mask, frames)
    med = statistics.median(times)
    res = {"family": "sst", "dtype": dtype, "frames": frames,
           "num_real_points": num_real, "latency_ms": med,
           "mean_ms": statistics.fmean(times), "fps": 1e3 / med,
           "unit": "frames/sec", "device": str(dev),
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "card": card_info() if dev.type == "cuda" else None}
    if profile_n:
        res.update(profile_frames(predict, points, mask, profile_n))
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("family", choices=["sst"])
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-real", type=int, default=150000,
                   help="real points in the synthetic frame")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="also trace N frames with torch.profiler")
    args = p.parse_args(argv)
    print(json.dumps(bench_sst(args.frames, args.dtype, args.device,
                               num_real=args.num_real,
                               profile_n=args.profile)))


if __name__ == "__main__":
    main()
