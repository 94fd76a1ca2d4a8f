"""Latency benchmark of the port (counterpart of the JAX repository's
``tools/benchmark.py`` and ``benchmarks/bench_detectors.py``).

    python -m objectcentricocccompletion_torch.tools.benchmark sst \\
        --frames 20 --dtype bfloat16
    python -m objectcentricocccompletion_torch.tools.benchmark sst \\
        --train --frames 10 --dtype bfloat16
    python -m objectcentricocccompletion_torch.tools.benchmark ococcnet \\
        [--frames 20] [--eval-layout dense] [--dtype float32]
    python -m objectcentricocccompletion_torch.tools.benchmark ococcnet \\
        --train [--frames 10] [--eval-layout dense] [--dtype float32] \\
        [--opt tree|flat|stacked]
    python -m objectcentricocccompletion_torch.tools.benchmark centerpoint \\
        [--train] [--frames 20] [--num-real 150000] \\
        [--encoder-layout column] [--dtype bfloat16]
    python -m objectcentricocccompletion_torch.tools.benchmark fsd|fsd2 \\
        [--train] [--frames 20] [--num-real 150000] [--dtype bfloat16]
    python -m objectcentricocccompletion_torch.tools.benchmark fsdpp \\
        [--train] [--frames 10] [--num-real 150000]
    python -m objectcentricocccompletion_torch.tools.benchmark annotate \\
        [--frames 3] [--profile 1]
    python -m objectcentricocccompletion_torch.tools.benchmark \\
        ococcnet|ctrl [--train] [--segmentor full] [--eval-layout dense] \\
        [--remat] [--dtype float32]
    python -m objectcentricocccompletion_torch.tools.benchmark votenet \\
        [--train] [--frames 10] [--dataset scannet|sunrgbd] [--profile 1]

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
tracklets/s and the peak memory over the timed steps. ``--opt flat`` /
``stacked`` trains with the flat or the stacked optimizer layout
(``create_train_state(flat_opt= | stacked_opt=)``; ``tree`` by default),
the counterpart of the JAX ``bench.py``'s ``BENCH_FLAT`` /
``BENCH_STACKED``.

``centerpoint`` builds the full-width ``DynamicCenterPoint(
CenterPointConfig())`` (float32; seeded random weights) and times
``predict`` on a ``synth_frame`` at the config's 160,000-point budget, or,
with ``--train``, training steps on it (its 32 boxes padded to 128); it
prints the latency and the peak memory as for ``sst``, and the occupied
voxels of each stage against its budget (the voxelized input, the
encoder's three downsampled stages and conv_out), which both packages cut
silently. ``--encoder-layout column`` runs the encoder's column-dense
layout instead (``--dtype``: its activations, the config's bfloat16 by
default; the gather layout computes in float32 whatever it says) and
prints the occupied columns of each stage against the column budgets.

``fsd`` / ``fsd2`` do the same with the training CLI's full-width ``FSD(
FSDConfig())`` / ``TwoStageFSD(TwoStageFSDConfig())`` (``--dtype`` sets
the compute dtype, float32 by default): with ``--train`` the step runs
``fsd_loss`` / ``two_stage_loss``; the budgets line gives the UNet's
voxels per level against ``max_voxels`` and per class the foreground
points over ``seg_score_thresh`` against ``max_fg_per_class``, the cluster
voxels against ``max_cluster_voxels`` and the clusters against
``max_clusters_per_class``.

``fsdpp`` builds the training CLI's full-width FSD++ (``FSDPPConfig()``:
two-stage, seeds, a memory of 320,000 points) and runs a sequence of
``--frames`` ``synth_frame``s (seeds 0, 1, ...) through
``make_sequential_predict_fn``, the memory carried: it prints each frame's
ms, the median from the third frame on (the memory full), the peak memory,
and per frame the novel points, the valid memory points, the valid seeds,
the memory points cropped by the seeds and the merged points kept. With
``--train`` it times window steps (window 2, the CLI's default) of
``make_seq_train_step`` over consecutive windows of ``synth_frame``s with
their boxes, the memory carried from step to step.

``annotate`` runs the W1 occupancy annotator (``tools_occ/annotate.py::
OccAnnotator``) on ``tools_occ/scenes.py::make_realistic_scene``: one car
tracklet of 100 frames, each with 160,000 background points and 150-400 on
the car, and five LiDARs (TOP 64 x 2650, four at 200 x 600). After one
untimed tracklet (which stages the range images into the device cache, as
the first tracklet of a segment does) it times ``--frames`` more of the
same segment and prints the ms per tracklet and its split: the host gather
and voxelization, the visibility test as the host sees it and on the
device (CUDA events), the npz write; the peak memory, the grid's unknown /
occupied / free counts and the window-attention launches (none).

``ctrl`` runs the same at the full width of ``ctrl_veh_config()`` (the RoI
encoder and heads only). ``--segmentor tiny|full`` turns on CTRL's
``TrackletSegmentor`` (``use_segmentor``) and adds its occupied voxels per
tracklet against its ``max_voxels``; ``--remat`` (with ``--eval-layout
dense``) recomputes the SIR encoders in the backward (``remat_sir``).

``votenet`` builds the full-width ``VoteNetConfig()`` of the training CLI
(ScanNet's 18 classes, or with ``--dataset sunrgbd`` SUN RGB-D's 10 with
yaw; seeded random weights) and times ``predict`` per frame, or with
``--train`` training steps, on a scene of 50,000 points written by
``data/indoor_dataset.py::write_indoor_scenes`` and read back by the
dataset's reader (40,000 kept); beside it the furthest point samplings
alone (each stage's input and sample counts, its ms, the host loop's steps
and, on the card, the kernels each step launches).

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
import tempfile
import time

import numpy as np
import torch

from ..configs.ococcnet_config import OcOccNetConfig, ctrl_veh_config
from ..data.indoor_dataset import (ScanNetDataset, SUNRGBDDataset,
                                   write_indoor_scenes)
from ..data.synthetic import synth_frame, synthetic_batch
from ..data.tracklet import TrackletBatch
from ..evalx.detector_eval import make_predict_fn, make_sequential_predict_fn
from ..models.centerpoint import DynamicCenterPoint
from ..models.ococcnet import OcOccNetWithLoss, gt_occ_to_roi_frame
from ..models.sst_detector import SSTDetector, SSTDetectorConfig
from ..ops import pointnet as pn
from ..ops import window_attention as wa
from ..parallel.train import create_train_state, make_train_step
from ..training.detector_trainer import (FrameBatch, collate_frames,
                                         make_detector_train_step)
from ..training.optim import make_optimizer
from ..training.seq_trainer import (SeqWindow, make_seq_train_step,
                                    step_generator)
from ..tools_occ import scenes
from ..tools_occ.annotate import OccAnnotator
from ..utils.device import card_info, resolve_device
from .train import build_detector


def sst_config(dtype: str = "bfloat16",
               cfg: SSTDetectorConfig | None = None) -> SSTDetectorConfig:
    cfg = cfg or SSTDetectorConfig()
    return dataclasses.replace(
        cfg, sst=dataclasses.replace(cfg.sst, compute_dtype=dtype))


def build_sst(cfg: SSTDetectorConfig, device="cuda", seed: int = 0
              ) -> SSTDetector:
    gen = torch.Generator().manual_seed(seed)
    return SSTDetector(cfg, device=device, generator=gen).eval()


def _frame_budget(cfg) -> tuple[int, tuple]:
    """(point budget, pc_range) of an SST, CenterPoint, FSD or two-stage
    FSD config."""
    c = getattr(cfg, "sst", None) or getattr(cfg, "fsd", cfg)
    return c.max_points, c.pc_range


def frame_tensors(cfg, device, num_real: int = 150000, seed: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """A ``synth_frame`` at the detector config's point budget, on
    ``device``."""
    points, mask, *_ = synth_frame(*_frame_budget(cfg), num_real=num_real,
                                   seed=seed)
    dev = resolve_device(device)
    return torch.from_numpy(points).to(dev), torch.from_numpy(mask).to(dev)


def train_batch(cfg, device, num_real: int = 150000,
                seed: int = 0) -> FrameBatch:
    """A one-frame batch of ``synth_frame`` with its boxes padded (or cut)
    to ``cfg.max_gt`` (CenterPoint: the frame datasets' 128), the padding
    invalid, on ``device``."""
    points, mask, boxes, labels, valid = synth_frame(
        *_frame_budget(cfg), num_real=num_real, seed=seed)
    max_gt = getattr(cfg, "max_gt", 128)
    m = min(len(boxes), max_gt)
    pad = {"gt_boxes": np.zeros((max_gt, 7), np.float32),
           "gt_labels": np.zeros((max_gt,), np.int32),
           "gt_valid": np.zeros((max_gt,), bool)}
    pad["gt_boxes"][:m], pad["gt_labels"][:m] = boxes[:m], labels[:m]
    pad["gt_valid"][:m] = valid[:m]
    return collate_frames([dict(points=points, points_mask=mask,
                                **pad)]).to(resolve_device(device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card(dev: torch.device) -> dict:
    """The device a result ran on, with the card's name and power limit."""
    return {"device": str(dev),
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "card": card_info() if dev.type == "cuda" else None}


def _peak_gib(dev: torch.device):
    return (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)


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
           "unit": "frames/sec", **_card(dev)}
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
           "peak_memory_gib": _peak_gib(dev),
           **_card(dev)}
    if profile_n:
        res.update(profile_calls(lambda: step_fn(next(count), batch),
                                 profile_n, dev, unit="step"))
    return res


def build_centerpoint(device="cuda", seed: int = 0, layout: str = "gather",
                      dtype: str | None = None) -> DynamicCenterPoint:
    """Full-width ``CenterPointConfig()`` with seeded random weights, its
    encoder in ``layout`` (``dtype``: the column layout's activations)."""
    return build_frame_detector("centerpoint", dtype, device, seed,
                                encoder_layout=layout)


def build_frame_detector(family: str, dtype: str | None = None,
                         device="cuda", seed: int = 0, **config_kw):
    """The full-width ``centerpoint``, ``fsd``, ``fsd2`` or ``fsdpp``
    detector of the training CLI (``dtype``: its ``--dtype``;
    ``config_kw``: CenterPoint's ``encoder_layout``) with seeded random
    weights."""
    return build_detector(family, dtype=dtype, device=device,
                          generator=torch.Generator().manual_seed(seed),
                          **config_kw).eval()


def budgets(model, points, mask) -> dict:
    """What the model's static budgets hold before they cut, beside them:
    CenterPoint's voxels per stage, FSD's UNet voxels per level and per
    class its foreground points, cluster voxels and clusters."""
    if isinstance(model, DynamicCenterPoint):
        return {"voxels": model.voxel_occupancy(points, mask)}
    return {"budgets": getattr(model, "stage1", model).budget_counts(
        points, mask)}


def bench_detector(family: str = "centerpoint", frames: int = 20,
                   dtype: str | None = None, device="cuda", seed: int = 0,
                   num_real: int = 150000, profile_n: int = 0,
                   **config_kw) -> dict:
    """Full-width ``predict`` of a frame detector (``centerpoint``, ``fsd``,
    ``fsd2``) per frame (median over ``frames`` after warm-up), the peak
    memory over the timed frames and the budgets' counts; ``config_kw``:
    CenterPoint's ``encoder_layout``."""
    dev = resolve_device(device)
    model = build_frame_detector(family, dtype, dev, seed, **config_kw)
    points, mask = frame_tensors(model.cfg, dev, num_real, seed)
    predict = make_predict_fn(model, family)
    predict(points, mask)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = time_frames(predict, points, mask, frames, warmup=1)
    med = statistics.median(times)
    res = {"family": family, "dtype": dtype or "float32", "frames": frames,
           **config_kw, "num_real_points": num_real, "latency_ms": med,
           "mean_ms": statistics.fmean(times), "fps": 1e3 / med,
           "unit": "frames/sec", "peak_memory_gib": _peak_gib(dev),
           **budgets(model, points, mask), **_card(dev)}
    if profile_n:
        res.update(profile_calls(lambda: predict(points, mask), profile_n,
                                 dev))
    return res


def bench_detector_train(family: str = "centerpoint", steps: int = 10,
                         dtype: str | None = None, device="cuda",
                         seed: int = 0, num_real: int = 150000,
                         profile_n: int = 0, warmup: int = 2,
                         **config_kw) -> dict:
    """Full-width training steps of a frame detector (forward, loss,
    backward, clip, AdamW at the schedule of ``train_detector``'s
    defaults) on one frame; the median step over ``steps`` after
    ``warmup``; ``config_kw``: CenterPoint's ``encoder_layout``."""
    dev = resolve_device(device)
    model = build_frame_detector(family, dtype, dev, seed,
                                 **config_kw).train()
    batch = train_batch(model.cfg, dev, num_real, seed)
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
    metrics = {}

    def step():
        metrics.update(step_fn(next(count), batch))

    times = time_calls(step, steps, dev, warmup=0)
    med = statistics.median(times)
    res = {"family": family, "mode": "train", "dtype": dtype or "float32",
           **config_kw, "steps": steps, "num_real_points": num_real,
           "step_ms": med,
           "mean_ms": statistics.fmean(times),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "peak_memory_gib": _peak_gib(dev),
           **budgets(model, batch.points[0], batch.points_mask[0]),
           **_card(dev)}
    if profile_n:
        res.update(profile_calls(step, profile_n, dev, unit="step"))
    return res


def sequence_counts(state, out, n_points: int) -> dict:
    """A FSD++ step's counts (0-d tensors): novel points of the frame that
    the step kept, valid memory points and valid seeds after it, memory
    points that the seeds cropped, merged points kept."""
    keep = out["input_mask"]
    return {"novel": keep[:n_points].sum(),
            "memory": state.memory_mask.sum(),
            "seeds": state.seeds.valid.sum(),
            "cropped": keep[n_points:].sum(), "merged": keep.sum()}


def bench_fsdpp(frames: int = 10, dtype: str | None = None, device="cuda",
                seed: int = 0, num_real: int = 150000,
                profile_n: int = 0) -> dict:
    """Full-width FSD++ over a sequence of ``frames`` synthetic frames (one
    sequence, the memory carried), after an untimed two-frame warm-up
    sequence: each frame's ms and peak memory, the median from the third
    frame on, the peak over the timed sequence and each frame's counts.
    Raises where a frame's boxes or scores are not finite or not of the
    step's shapes."""
    dev = resolve_device(device)
    model = build_frame_detector("fsdpp", dtype, dev, seed)
    step = make_sequential_predict_fn(model)
    n_slots = model.cfg.fsd.max_clusters
    seq = [frame_tensors(model.cfg, dev, num_real, seed + i)
           for i in range(frames)]
    counts = []
    hook = model.register_forward_hook(
        lambda mod, args, res: counts.append(
            sequence_counts(res[0], res[1], args[1].shape[0])))
    mem = model.init_state(seq[0][0].shape[-1])
    for pts, msk in seq[:2]:
        mem, _ = step(mem, pts, msk)
    _sync(dev)
    counts.clear()
    times, peaks = [], []
    mem = model.init_state(seq[0][0].shape[-1])
    for pts, msk in seq:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        mem, (boxes, scores, labels, valid) = step(mem, pts, msk)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        peaks.append(_peak_gib(dev))
        shapes = [tuple(x.shape) for x in (boxes, scores, labels, valid)]
        if shapes != [(n_slots, 7), (n_slots,), (n_slots,), (n_slots,)] or \
                not (torch.isfinite(boxes[valid]).all()
                     and torch.isfinite(scores).all()):
            raise AssertionError(f"fsdpp predict: shapes {shapes} or values "
                                 f"not finite")
    hook.remove()
    mid = times[2:] or times
    res = {"family": "fsdpp", "dtype": dtype or "float32", "frames": frames,
           "num_real_points": num_real,
           "latency_ms": statistics.median(mid),
           "first_frame_ms": times[0], "frame_ms": times,
           "fps": 1e3 / statistics.median(mid), "unit": "frames/sec",
           "peak_memory_gib": None if peaks[0] is None else max(peaks),
           "frame_peak_gib": peaks,
           "counts": [{k: int(v) for k, v in c.items()} for c in counts],
           **_card(dev)}
    if profile_n:
        state = [mem]

        def frame():
            state[0], _ = step(state[0], *seq[-1])
        res.update(profile_calls(frame, profile_n, dev))
    return res


def bench_fsdpp_train(steps: int = 10, dtype: str | None = None,
                      device="cuda", seed: int = 0, num_real: int = 150000,
                      profile_n: int = 0, warmup: int = 2,
                      window: int = 2) -> dict:
    """Full-width FSD++ window steps (``window`` frames, the seed
    augmentation, the mean loss, backward, clip, AdamW at the schedule of
    ``train_fsdpp``'s defaults) over consecutive windows of one sequence of
    synthetic frames (every step its own frames), the memory carried from
    step to step; the median step over ``steps`` after ``warmup``."""
    dev = resolve_device(device)
    model = build_frame_detector("fsdpp", dtype, dev, seed).train()
    total = warmup + steps + profile_n
    frames = [train_batch(model.cfg, dev, num_real, seed + i)
              for i in range(total * window)]
    windows = [SeqWindow(*(torch.cat(t, 0) for t in zip(
        *frames[i * window:(i + 1) * window]))) for i in range(total)]
    optimizer, schedule = make_optimizer(model.named_parameters(),
                                         base_lr=1e-5, total_steps=total)
    step_fn = make_seq_train_step(model, optimizer, schedule, window)
    count = iter(range(total))
    state = {"mem": model.init_state(windows[0].points.shape[-1]),
             "metrics": {}}

    def step():
        i = next(count)
        state["mem"], state["metrics"] = step_fn(
            i, windows[i], state["mem"], generator=step_generator(seed, i))

    for _ in range(warmup):
        step()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = time_calls(step, steps, dev, warmup=0)
    med = statistics.median(times)
    res = {"family": "fsdpp", "mode": "train", "dtype": dtype or "float32",
           "steps": steps, "window": window, "num_real_points": num_real,
           "step_ms": med, "mean_ms": statistics.fmean(times),
           "step_ms_all": times,
           "metrics": {k: float(v) for k, v in state["metrics"].items()},
           "peak_memory_gib": _peak_gib(dev), **_card(dev)}
    if profile_n:
        res.update(profile_calls(step, profile_n, dev, unit="step"))
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


def occ_bench_config(family: str = "ococcnet", segmentor: str | None = None,
                     remat: bool = False) -> OcOccNetConfig:
    """The full-width ``OcOccNetConfig()`` (``ctrl``: ``ctrl_veh_config()``)
    with CTRL's segmentor (``tiny`` / ``full``) and SIR remat as asked."""
    cfg = ctrl_veh_config() if family == "ctrl" else OcOccNetConfig()
    return dataclasses.replace(cfg, use_segmentor=segmentor,
                               remat_sir=remat)


def occ_options(model: OcOccNetWithLoss, b: TrackletBatch) -> dict:
    """The variant and options of the config; with the segmentor, each
    tracklet's occupied voxels before its ``max_voxels`` cut."""
    cfg = model.cfg
    res = {"variant": cfg.variant, "use_segmentor": cfg.use_segmentor,
           "remat_sir": cfg.remat_sir}
    if cfg.use_segmentor:
        seg = model.net.segmentor
        B = b.points.shape[0]
        points, mask = b.points.reshape(B, -1, b.points.shape[-1]), \
            b.points_mask.reshape(B, -1)
        res["segmentor_voxels"] = [seg.voxel_count(points[i, :, :3], mask[i])
                                   for i in range(B)]
        res["segmentor_max_voxels"] = seg.cfg.max_voxels
    return res


def bench_ococcnet(batches: int = 20, dtype: str = "bfloat16",
                   layout: str = "packed", device="cuda", seed: int = 0,
                   profile_n: int = 0, cfg: OcOccNetConfig | None = None,
                   batch: int = OCC_BATCH) -> dict:
    """OcOccNet serving at full width: ``predict`` per batch of ``batch``
    tracklets, then the occupancy decode of its queries (not for CTRL,
    which has no decoder), each timed apart (median over ``batches`` after
    warm-up)."""
    dev = resolve_device(device)
    cfg = ococcnet_config(dtype, layout, cfg)
    model = build_ococcnet(cfg, dev, seed)
    b, queries = tracklet_batch(cfg, dev, batch, seed)
    with_occ = cfg.variant == "ococc"

    @torch.inference_mode()
    def serve():
        o = model.predict(b)
        if with_occ:
            model.decode_occ_queries(o["shape_latent"], queries)

    with torch.inference_mode():
        out = model.predict(b)
        shapes = {k: list(v.shape) for k, v in out.items()}
        if with_occ:
            occ = model.decode_occ_queries(out["shape_latent"], queries)
            shapes["occ_logits"] = list(occ.shape)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        times = time_calls(lambda: model.predict(b), batches, dev)
        dec = None
        if with_occ:
            dec = time_calls(
                lambda: model.decode_occ_queries(out["shape_latent"],
                                                 queries), batches, dev)
    med = statistics.median(times)
    res = {"family": "ococcnet", **occ_options(model, b), "dtype": dtype,
           "eval_layout": layout,
           "batch": batch, "batches": batches, "latency_ms": med,
           "mean_ms": statistics.fmean(times), "fps": batch * 1e3 / med,
           "unit": "tracklets/sec",
           "decode_ms": statistics.median(dec) if with_occ else None,
           "decode_queries": queries.shape[2], **layout_points(model, b),
           "peak_memory_gib": _peak_gib(dev),
           "shapes": shapes, **_card(dev)}
    if profile_n:
        res.update(profile_calls(serve, profile_n, dev, unit="batch"))
    return res


def bench_ococcnet_train(steps: int = 10, dtype: str = "bfloat16",
                         layout: str = "packed", device="cuda",
                         seed: int = 0, profile_n: int = 0,
                         cfg: OcOccNetConfig | None = None,
                         batch: int = OCC_BATCH, warmup: int = 2,
                         opt: str = "tree") -> dict:
    """OcOccNet training steps at full width on one ``synthetic_batch`` of
    ``batch`` tracklets; the step time is the median over ``steps`` after
    ``warmup``; one more step gives the metrics. ``opt``: the optimizer
    layout, ``tree``, ``flat`` or ``stacked``."""
    dev = resolve_device(device)
    cfg = ococcnet_config(dtype, layout, cfg)
    total = warmup + steps + 1 + profile_n
    state = create_train_state(cfg, total, dev, seed,
                               flat_opt=opt == "flat",
                               stacked_opt=opt == "stacked")
    model, optimizer, schedule = state[:3]
    b = synthetic_batch(cfg, batch_size=batch, seed=seed).to(dev)
    step_fn = make_train_step(
        model, optimizer, schedule, seed=seed + 1, flat_opt=opt == "flat",
        stacked_spec=state[3] if opt == "stacked" else None)
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
    res = {"family": "ococcnet", **occ_options(model, b), "mode": "train",
           "dtype": dtype, "eval_layout": layout, "opt": opt, "batch": batch,
           "steps": steps,
           "step_ms": med, "mean_ms": statistics.fmean(times),
           "fps": batch * 1e3 / med, "unit": "tracklets/sec",
           "metrics": metrics, **layout_points(model, b),
           "peak_memory_gib": _peak_gib(dev),
           **_card(dev)}
    if profile_n:
        res.update(profile_calls(lambda: step_fn(next(count), b), profile_n,
                                 dev, unit="step"))
    return res


def bench_annotate(tracklets: int = 3, device="cuda", profile_n: int = 0
                   ) -> dict:
    """The annotator's ms per tracklet on the benchmark scene, split by
    stage (see the module's docstring)."""
    dev = resolve_device(device)
    boxes, ts_list, get_points, get_raw_frame = \
        scenes.make_realistic_scene()
    with tempfile.TemporaryDirectory() as out:
        ann = OccAnnotator(get_points, get_raw_frame, out, overwrite=True,
                           device=dev)
        t0 = time.perf_counter()
        ann.annotate_trk("seg", "warmup", boxes, ts_list)
        first_ms = (time.perf_counter() - t0) * 1e3
        for k in ann.timing:
            ann.timing[k] = 0.0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        times = []
        for i in range(tracklets):
            t0 = time.perf_counter()
            path = ann.annotate_trk("seg", f"trk{i}", boxes, ts_list)
            times.append((time.perf_counter() - t0) * 1e3)
        occ = np.load(path)["occ"]
        launches = sum(wa.LAUNCHES.values()) + sum(wa.BWD_LAUNCHES.values())
        res = {"family": "annotate", "frames_per_tracklet": len(ts_list),
               "sensors": 5, "ms_per_tracklet": statistics.median(times),
               "ms_per_tracklet_all": times, "first_tracklet_ms": first_ms,
               **{f"{k[:-2]}_ms_per_tracklet": v * 1e3 / tracklets
                  for k, v in ann.timing.items() if k.endswith("_s")},
               "device_visibility_ms_per_tracklet": (
                   ann.timing["device_ms"] / tracklets
                   if dev.type == "cuda" else None),
               "peak_gib": _peak_gib(dev), "grid": list(occ.shape),
               "unknown_occupied_free": [int((occ == v).sum())
                                         for v in (0, 1, 2)],
               "window_attention_launches": launches, **_card(dev)}
        if profile_n:
            res.update(profile_calls(
                lambda: ann.annotate_trk("seg", "prof", boxes, ts_list),
                profile_n, dev, unit="tracklet"))
    return res


INDOOR_POINTS = 50000     # points per written scene (40,000 kept)


def build_votenet(dataset: str = "scannet", device="cuda", seed: int = 0):
    """The training CLI's full-width VoteNet for ``dataset`` (``scannet``
    or ``sunrgbd``) with seeded random weights."""
    reader = SUNRGBDDataset if dataset == "sunrgbd" else ScanNetDataset
    return build_detector(
        "votenet", device=device, generator=torch.Generator().manual_seed(
            seed), point_dim=6, num_classes=len(reader.CLASSES),
        with_yaw=dataset == "sunrgbd").eval()


def indoor_batch(dataset: str = "scannet", device="cuda", seed: int = 0
                 ) -> FrameBatch:
    """One scene of ``write_indoor_scenes`` through the dataset's reader,
    as a one-frame batch on ``device``."""
    yawed = dataset == "sunrgbd"
    with tempfile.TemporaryDirectory() as root:
        info = write_indoor_scenes(root, 1, INDOOR_POINTS, yawed, seed=seed)
        reader = SUNRGBDDataset if yawed else ScanNetDataset
        s = reader(info, root).build_sample(0, np.random.RandomState(seed))
    s.pop("meta")
    return collate_frames([s]).to(resolve_device(device))


def fps_stages(cfg) -> list[tuple[int, int]]:
    """(input points, samples) of each furthest point sampling of a VoteNet
    forward: the set abstractions, then the proposals among the seeds."""
    sizes = [cfg.max_points] + [sa[0] for sa in cfg.sa_layers]
    stages = list(zip(sizes[:-1], sizes[1:]))
    return stages + [(sizes[-1 - len(cfg.fp_channels)], cfg.num_proposals)]


def fps_costs(cfg, device: torch.device, reps: int = 3) -> dict:
    """The furthest point samplings of one forward alone: each stage's ms
    (median of ``reps``, uniform points), the host loop's steps and, on the
    card, the kernels one step launches (the difference of two traced
    calls' kernel counts over their difference in steps)."""
    gen = torch.Generator().manual_seed(0)
    ms = []
    for n, k in fps_stages(cfg):
        pts = (8 * torch.rand(n, 3, generator=gen)).to(device)
        mask = torch.ones(n, dtype=torch.bool, device=device)
        ms.append(statistics.median(time_calls(
            lambda: pn.furthest_point_sample(pts, mask, k), reps, device,
            warmup=1)))
    steps = sum(k - 1 for _, k in fps_stages(cfg))
    res = {"fps_stages": fps_stages(cfg), "fps_ms_by_stage": ms,
           "fps_ms_per_frame": sum(ms), "fps_steps_per_frame": steps,
           "fps_kernels_per_step": None, "fps_launches_per_frame": None}
    if device.type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        counts = []
        for k in (65, 129):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pn.furthest_point_sample(pts, mask, k)
                _sync(device)
            counts.append(sum(e.count for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA))
        per_step = (counts[1] - counts[0]) / 64
        res.update(fps_kernels_per_step=per_step,
                   fps_launches_per_frame=per_step * steps)
    return res


def bench_votenet(frames: int = 10, train: bool = False,
                  dataset: str = "scannet", device="cuda", seed: int = 0,
                  profile_n: int = 0, warmup: int = 2) -> dict:
    """Full-width VoteNet ``predict`` per frame, or training steps
    (forward, loss, backward, clip, AdamW at ``train_detector``'s
    defaults), on one written scene: the median over ``frames`` after
    ``warmup``, the peak memory and the furthest point samplings' costs."""
    dev = resolve_device(device)
    model = build_votenet(dataset, dev, seed)
    batch = indoor_batch(dataset, dev, seed)
    points, mask = batch.points[0], batch.points_mask[0]
    if train:
        model.train()
        optimizer, schedule = make_optimizer(
            model.named_parameters(), base_lr=1e-5,
            total_steps=warmup + frames + profile_n)
        step_fn = make_detector_train_step(model, optimizer, schedule)
        count = iter(range(warmup + frames + profile_n))

        def call():
            step_fn(next(count), batch)
    else:
        predict = make_predict_fn(model, "votenet")

        def call():
            predict(points, mask)
    for _ in range(warmup):
        call()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = time_calls(call, frames, dev, warmup=0)
    med = statistics.median(times)
    unit = "step" if train else "frame"
    res = {"family": "votenet", "dataset": dataset,
           "mode": "train" if train else "predict",
           "num_classes": model.cfg.num_classes,
           "with_yaw": model.cfg.with_yaw, "frames": frames,
           "points": int(mask.sum()), f"ms_per_{unit}": med,
           "mean_ms": statistics.fmean(times),
           "peak_memory_gib": _peak_gib(dev),
           **fps_costs(model.cfg, dev), **_card(dev)}
    if profile_n:
        res.update(profile_calls(call, profile_n, dev, unit=unit))
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("family", choices=["sst", "ococcnet", "ctrl",
                                      "centerpoint", "fsd", "fsd2", "fsdpp",
                                      "annotate", "votenet"])
    p.add_argument("--frames", type=int, default=20,
                   help="timed frames (with --train: timed steps; "
                        "ococcnet: timed batches; annotate: timed "
                        "tracklets)")
    p.add_argument("--eval-layout", choices=LAYOUTS, default="packed",
                   help="ococcnet / ctrl: point layout")
    p.add_argument("--segmentor", choices=["tiny", "full"], default=None,
                   help="ococcnet / ctrl: CTRL's tracklet segmentor")
    p.add_argument("--remat", action="store_true",
                   help="ococcnet / ctrl with --eval-layout dense: "
                        "recompute the SIR encoders in the backward")
    p.add_argument("--dataset", choices=["scannet", "sunrgbd"],
                   default="scannet", help="votenet: the scene's form")
    p.add_argument("--train", action="store_true",
                   help="time training steps instead of predict")
    p.add_argument("--dtype", default=None,
                   choices=["bfloat16", "float32"],
                   help="sst / ococcnet: bfloat16 by default; fsd / fsd2 / "
                        "fsdpp: float32 by default; centerpoint: the column "
                        "layout's activations (bfloat16 by default; the "
                        "gather layout computes in float32)")
    p.add_argument("--encoder-layout", choices=["gather", "column"],
                   default="gather",
                   help="centerpoint: the sparse encoder's layout")
    p.add_argument("--opt", choices=["tree", "flat", "stacked"],
                   default="tree",
                   help="ococcnet / ctrl --train: the optimizer layout")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-real", type=int, default=150000,
                   help="real points in the synthetic frame")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="also trace N frames (or steps) with "
                        "torch.profiler")
    args = p.parse_args(argv)
    if args.remat and args.eval_layout != "dense":
        raise SystemExit("--remat applies to --eval-layout dense (the "
                         "packed layout ignores remat_sir)")
    if args.family == "votenet":
        print(json.dumps(bench_votenet(args.frames, args.train, args.dataset,
                                       args.device,
                                       profile_n=args.profile)))
        return
    if args.family == "annotate":
        print(json.dumps(bench_annotate(args.frames, args.device,
                                        args.profile)))
        return
    if args.family == "fsdpp":
        bench = bench_fsdpp_train if args.train else bench_fsdpp
        print(json.dumps(bench(args.frames, args.dtype, args.device,
                               num_real=args.num_real,
                               profile_n=args.profile)))
        return
    if args.family in ("centerpoint", "fsd", "fsd2"):
        if args.family == "centerpoint" and args.dtype not in (
                None, "float32") and args.encoder_layout == "gather":
            raise SystemExit("centerpoint's gather layout computes in "
                             "float32 end to end")
        kw = ({"encoder_layout": args.encoder_layout}
              if args.family == "centerpoint" else {})
        bench = bench_detector_train if args.train else bench_detector
        print(json.dumps(bench(args.family, args.frames, args.dtype,
                               args.device, num_real=args.num_real,
                               profile_n=args.profile, **kw)))
        return
    args.dtype = args.dtype or "bfloat16"
    if args.family in ("ococcnet", "ctrl"):
        kw = {"opt": args.opt} if args.train else {}
        if args.opt != "tree" and not args.train:
            raise SystemExit("--opt applies to --train")
        bench = bench_ococcnet_train if args.train else bench_ococcnet
        print(json.dumps(bench(
            args.frames, args.dtype, args.eval_layout, args.device,
            profile_n=args.profile, cfg=occ_bench_config(
                args.family, args.segmentor, args.remat), **kw)))
        return
    bench = bench_sst_train if args.train else bench_sst
    print(json.dumps(bench(args.frames, args.dtype, args.device,
                           num_real=args.num_real, profile_n=args.profile)))


if __name__ == "__main__":
    main()
