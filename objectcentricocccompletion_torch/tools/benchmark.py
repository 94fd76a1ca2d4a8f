"""Latency benchmark of the port (counterpart of the JAX repository's
``tools/benchmark.py`` and ``benchmarks/bench_detectors.py``; the ``sst``
and ``ococcnet`` families so far).

    python -m objectcentricocccompletion_torch.tools.benchmark sst \\
        --frames 20 --dtype bfloat16
    python -m objectcentricocccompletion_torch.tools.benchmark sst \\
        --train --frames 10 --dtype bfloat16
    python -m objectcentricocccompletion_torch.tools.benchmark ococcnet \\
        [--frames 20] [--eval-layout dense] [--dtype float32]
    python -m objectcentricocccompletion_torch.tools.benchmark ococcnet \\
        --train [--frames 10] [--eval-layout dense] [--dtype float32]

``sst`` builds the full-width ``SSTDetector(SSTDetectorConfig())`` with
weights drawn from a seeded ``torch.Generator`` (no checkpoint is needed). By
default it runs ``predict`` on a seeded synthetic frame after warm-up and
prints one JSON line: the per-frame latency (host clock around work that
ends in a device synchronise), the device, and the card's name and power
limit. With ``--train`` it runs full training steps instead (forward, loss,
backward, global-norm clip, AdamW) on the same frame with its 32 boxes
padded to ``max_gt``, and prints the per-step latency and the peak of
``torch.cuda.max_memory_allocated`` over the timed steps.

``ococcnet`` builds the full-width ``OcOccNetConfig()`` with seeded random
weights, in the packed point layout (the config default, which the JAX
``tools/benchmark.py ococcnet`` runs) or the dense one with the
``roi_point_budget`` compaction (``tools/test.py``'s default eval layout),
on ``synthetic_batch(cfg, batch_size=4, seed=0)``. It times ``predict`` per
batch and, apart, the occupancy decode of the batch's K=512 queries per
frame (``gt_occ_to_roi_frame`` of the batch's samples), each the median
over the timed batches after warm-up, and prints the per-batch latency,
tracklets/s, the decode time, the peak of
``torch.cuda.max_memory_allocated`` and the points the layout keeps. With
``--train`` it runs full training steps on that batch instead (the losses
with the config's dropout, backward, clip, AdamW: ``parallel/train.py``)
and prints the per-step latency (host clock around a step that ends in a
device synchronise, median over the timed steps after warm-up),
tracklets/s and the peak memory over the timed steps.

``--profile N`` also traces N more frames (steps; for ``ococcnet``
batches, predict and decode) with ``torch.profiler``, prints the operators
that take the most device time, and adds the device's busy time per frame
(step, batch), the kernels and copies it ran per frame (step, batch) and
the busy share (kernel time over wall time) to the line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from ..configs.ococcnet_config import OcOccNetConfig
from ..data.synthetic import synth_frame, synthetic_batch
from ..data.tracklet import TrackletBatch
from ..evalx.detector_eval import make_predict_fn
from ..models.ococcnet import OcOccNetWithLoss, gt_occ_to_roi_frame
from ..models.sst_detector import SSTDetector, SSTDetectorConfig
from ..parallel.train import create_train_state, make_train_step
from ..training.detector_trainer import (FrameBatch, collate_frames,
                                         make_detector_train_step)
from ..training.optim import make_optimizer
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


def train_batch(cfg: SSTDetectorConfig, device, num_real: int = 150000,
                seed: int = 0) -> FrameBatch:
    """A one-frame batch of ``synth_frame`` with its boxes padded (or cut)
    to ``cfg.max_gt``, the padding invalid, on ``device``."""
    points, mask, boxes, labels, valid = synth_frame(
        cfg.sst.max_points, cfg.sst.pc_range, num_real=num_real, seed=seed)
    m = min(len(boxes), cfg.max_gt)
    pad = {"gt_boxes": np.zeros((cfg.max_gt, 7), np.float32),
           "gt_labels": np.zeros((cfg.max_gt,), np.int32),
           "gt_valid": np.zeros((cfg.max_gt,), bool)}
    pad["gt_boxes"][:m], pad["gt_labels"][:m] = boxes[:m], labels[:m]
    pad["gt_valid"][:m] = valid[:m]
    return collate_frames([dict(points=points, points_mask=mask,
                                **pad)]).to(resolve_device(device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, n: int, device: torch.device, warmup: int = 2
               ) -> list[float]:
    """Milliseconds of each of ``n`` calls of ``fn()`` after ``warmup``
    untimed ones; each call ends in a device synchronise."""
    for _ in range(warmup):
        fn()
    _sync(device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def time_frames(predict, points, mask, frames: int, warmup: int = 2
                ) -> list[float]:
    """Milliseconds of each of ``frames`` predict calls after ``warmup``
    untimed ones; each call ends in a device synchronise."""
    return time_calls(lambda: predict(points, mask), frames, points.device,
                      warmup)


def profile_calls(fn, n: int, device: torch.device, unit: str = "frame",
                  row_limit: int = 25) -> dict:
    """Trace ``n`` calls of ``fn()`` on the card; print the operators by
    device time and return the device busy time per call and busy share
    (summed kernel and copy time over the traced wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    print(avgs.table(sort_by="self_device_time_total", row_limit=row_limit,
                     max_name_column_width=60))
    # kernels and copies only: an operator's row repeats its kernels' time
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # the hand-written attention kernels (csrc/window_attention*.cu)
    attn_ms = sum(e.self_device_time_total for e in kernels
                  if "window_attention" in e.key) / 1e3
    return {f"device_busy_ms_per_{unit}": busy_ms / n,
            # kernels and copies the card ran per call
            f"device_calls_per_{unit}": sum(e.count for e in kernels) / n,
            "device_busy_share": busy_ms / wall_ms,
            f"attention_kernel_ms_per_{unit}": attn_ms / n,
            f"profiled_wall_ms_per_{unit}": wall_ms / n}


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
        res.update(profile_calls(lambda: predict(points, mask), profile_n,
                                 dev))
    return res


def bench_sst_train(steps: int, dtype: str = "bfloat16", device="cuda",
                    seed: int = 0, num_real: int = 150000,
                    profile_n: int = 0, warmup: int = 2) -> dict:
    """Full-width SST training steps (forward, loss, backward, clip,
    AdamW at the schedule of ``train_detector``'s defaults) on one frame;
    the step time is the host clock around a step that ends in a device
    synchronise, the median over ``steps`` after ``warmup``."""
    dev = resolve_device(device)
    cfg = sst_config(dtype)
    model = build_sst(cfg, dev, seed).train()
    batch = train_batch(cfg, dev, num_real, seed)
    optimizer, schedule = make_optimizer(
        model.named_parameters(), base_lr=1e-5,
        total_steps=warmup + steps + profile_n)
    step_fn = make_detector_train_step(model, optimizer, schedule)
    count = iter(range(warmup + steps + profile_n))
    for _ in range(warmup):
        step_fn(next(count), batch)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times, metrics = [], {}
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = step_fn(next(count), batch)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    res = {"family": "sst", "mode": "train", "dtype": dtype,
           "steps": steps, "num_real_points": num_real, "step_ms": med,
           "mean_ms": statistics.fmean(times),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                               if dev.type == "cuda" else None),
           "device": str(dev),
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "card": card_info() if dev.type == "cuda" else None}
    if profile_n:
        res.update(profile_calls(lambda: step_fn(next(count), batch),
                                 profile_n, dev, unit="step"))
    return res


LAYOUTS = ("packed", "dense")
# tracklets per batch, the JAX benchmark's
OCC_BATCH = 4


def ococcnet_config(dtype: str = "bfloat16", layout: str = "packed",
                    cfg: OcOccNetConfig | None = None) -> OcOccNetConfig:
    """``cfg`` (the full-width default) in ``dtype`` and an eval point
    layout: ``packed`` keeps the config's packed budget, ``dense`` turns
    it off (``tools/test.py --eval-layout dense``), which leaves the
    ``roi_point_budget`` compaction."""
    if layout not in LAYOUTS:
        raise ValueError(f"eval layout {layout!r}; one of {LAYOUTS}")
    cfg = cfg or OcOccNetConfig()
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    if layout == "dense":
        cfg = dataclasses.replace(cfg, packed_point_budget=None)
    return cfg


def build_ococcnet(cfg: OcOccNetConfig, device="cuda", seed: int = 0
                   ) -> OcOccNetWithLoss:
    gen = torch.Generator().manual_seed(seed)
    return OcOccNetWithLoss(cfg, device=device, generator=gen).eval()


def tracklet_batch(cfg: OcOccNetConfig, device, batch: int = OCC_BATCH,
                   seed: int = 0) -> tuple[TrackletBatch, torch.Tensor]:
    """``synthetic_batch`` and its occupancy queries in each RoI's frame
    ([B, L, K, 3]), on ``device``."""
    b = synthetic_batch(cfg, batch_size=batch, seed=seed).to(
        resolve_device(device))
    return b, gt_occ_to_roi_frame(b.occ_points, b.gt_boxes, b.rois)


def layout_points(model: OcOccNetWithLoss, b: TrackletBatch) -> dict:
    """The batch's points: valid in the input, pooled into their frame's
    RoI (with its margin), and kept by the model's point layout, beside
    the layout's slots."""
    layout = model.net.point_layout(b)
    kept = layout.kept()
    return {"points_valid": int(b.points_mask.sum()),
            "points_pooled": int(layout.pool.mask.sum()),
            "points_kept": int(kept.sum()), "point_slots": kept.numel()}


def bench_ococcnet(batches: int = 20, dtype: str = "bfloat16",
                   layout: str = "packed", device="cuda", seed: int = 0,
                   profile_n: int = 0, cfg: OcOccNetConfig | None = None,
                   batch: int = OCC_BATCH) -> dict:
    """OcOccNet serving at full width: ``predict`` per batch of ``batch``
    tracklets, then the occupancy decode of its queries, each timed apart
    (median over ``batches`` after warm-up)."""
    dev = resolve_device(device)
    cfg = ococcnet_config(dtype, layout, cfg)
    model = build_ococcnet(cfg, dev, seed)
    b, queries = tracklet_batch(cfg, dev, batch, seed)
    with torch.inference_mode():
        out = model.predict(b)
        occ = model.decode_occ_queries(out["shape_latent"], queries)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        times = time_calls(lambda: model.predict(b), batches, dev)
        dec = time_calls(
            lambda: model.decode_occ_queries(out["shape_latent"], queries),
            batches, dev)
    med = statistics.median(times)
    shapes = {k: list(v.shape) for k, v in out.items()}
    shapes["occ_logits"] = list(occ.shape)
    res = {"family": "ococcnet", "dtype": dtype, "eval_layout": layout,
           "batch": batch, "batches": batches, "latency_ms": med,
           "mean_ms": statistics.fmean(times), "fps": batch * 1e3 / med,
           "unit": "tracklets/sec", "decode_ms": statistics.median(dec),
           "decode_queries": queries.shape[2], **layout_points(model, b),
           "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                               if dev.type == "cuda" else None),
           "shapes": shapes, "device": str(dev),
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "card": card_info() if dev.type == "cuda" else None}
    if profile_n:
        @torch.inference_mode()
        def serve():
            o = model.predict(b)
            model.decode_occ_queries(o["shape_latent"], queries)
        res.update(profile_calls(serve, profile_n, dev, unit="batch"))
    return res


def bench_ococcnet_train(steps: int = 10, dtype: str = "bfloat16",
                         layout: str = "packed", device="cuda",
                         seed: int = 0, profile_n: int = 0,
                         cfg: OcOccNetConfig | None = None,
                         batch: int = OCC_BATCH, warmup: int = 2) -> dict:
    """OcOccNet training steps at full width on one ``synthetic_batch`` of
    ``batch`` tracklets; the step time is the median over ``steps`` after
    ``warmup``; one more step gives the metrics."""
    dev = resolve_device(device)
    cfg = ococcnet_config(dtype, layout, cfg)
    total = warmup + steps + 1 + profile_n
    model, optimizer, schedule = create_train_state(cfg, total, dev, seed)
    b = synthetic_batch(cfg, batch_size=batch, seed=seed).to(dev)
    step_fn = make_train_step(model, optimizer, schedule, seed=seed + 1)
    count = iter(range(total))
    for _ in range(warmup):
        step_fn(next(count), b)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = time_calls(lambda: step_fn(next(count), b), steps, dev,
                       warmup=0)
    metrics = {k: float(v) for k, v in step_fn(next(count), b).items()}
    med = statistics.median(times)
    res = {"family": "ococcnet", "mode": "train", "dtype": dtype,
           "eval_layout": layout, "batch": batch, "steps": steps,
           "step_ms": med, "mean_ms": statistics.fmean(times),
           "fps": batch * 1e3 / med, "unit": "tracklets/sec",
           "metrics": metrics, **layout_points(model, b),
           "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                               if dev.type == "cuda" else None),
           "device": str(dev),
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "card": card_info() if dev.type == "cuda" else None}
    if profile_n:
        res.update(profile_calls(lambda: step_fn(next(count), b), profile_n,
                                 dev, unit="step"))
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("family", choices=["sst", "ococcnet"])
    p.add_argument("--frames", type=int, default=20,
                   help="timed frames (with --train: timed steps; "
                        "ococcnet: timed batches)")
    p.add_argument("--eval-layout", choices=LAYOUTS, default="packed",
                   help="ococcnet: point layout")
    p.add_argument("--train", action="store_true",
                   help="time training steps instead of predict")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-real", type=int, default=150000,
                   help="real points in the synthetic frame")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="also trace N frames (or steps) with "
                        "torch.profiler")
    args = p.parse_args(argv)
    if args.family == "ococcnet":
        bench = bench_ococcnet_train if args.train else bench_ococcnet
        print(json.dumps(bench(
            args.frames, args.dtype, args.eval_layout, args.device,
            profile_n=args.profile)))
        return
    bench = bench_sst_train if args.train else bench_sst
    print(json.dumps(bench(args.frames, args.dtype, args.device,
                           num_real=args.num_real, profile_n=args.profile)))


if __name__ == "__main__":
    main()
