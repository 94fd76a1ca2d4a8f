#!/usr/bin/env python3
"""Drive the PyTorch port's SST inference, training and evaluation paths,
its OcOccNet serving, training and evaluation paths, and the inference,
training and evaluation paths of CenterPoint, of the FSD family and of
FSD++, FSDv2 training on predicted occupancy (W8), the W1 occupancy
annotator, the data-prep CLI and augmented multi-sweep training, CTRL with
its tracklet segmentor, SIR remat, the tracklet loader's worker processes,
VoteNet on indoor scenes and SST on nuScenes frames, checkpoint surgery,
the serving export, data-parallel training and sharded evaluation, model
parallelism, CenterPoint's column-dense encoder layout, OcOccNet's flat
and stacked optimizer layouts (also under data parallelism) and the
benchmark CLI on trained weights, on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. Build every CUDA kernel of the path from ``objectcentricocccompletion_torch/
   csrc`` with nvcc (into ``build/``); print the build log and time and the
   card's name and power limit.
2. Hold the window-attention forward kernels against their plain PyTorch
   version on the card at both production shapes (small level W=3200, T=32;
   large level W=800, T=144; C=128, H=8) and at the shapes of
   ``CHECK_SHAPES`` (head dims 8 and 32, ragged T=20 and T=100), in float32
   (the 3xTF32 tensor-core kernel, atol 1e-5) and bfloat16 (the bf16
   tensor-core kernel, atol 2e-2, compared in float32), with random masks
   and one window in eight fully masked (exactly the mean of v). Time the
   kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick only; the port never calls it) with CUDA events, medians of 20
   calls each, beside the bound (``attention_bound_ms``) and the
   exponentials' floor.
3. Run full-width ``SSTDetector(SSTDetectorConfig())`` inference in bfloat16
   through the benchmark entry point's functions on two seeded synthetic
   frames (dense: 150000 points; sparse: 20000). The launch counts are set
   to 0 just before this run and read just after: each frame must launch
   the kernel exactly 24 times (6 blocks x 2 shifts x 2 levels). Outputs
   must be finite and of the predict shapes. Then one frame in float32
   (TF32 off; the SST's depth cut to ``FP32_CHECK_BLOCKS`` of its 6
   blocks) with the kernel and with the plain attention, same weights,
   compared at a stated tolerance; and the same frame through the port on
   the CPU (the path the CPU tests hold to the JAX package), from the card
   with TF32 off and again under the training CLI's settings (cuDNN
   convolutions in TF32, matmuls not), each at its stated tolerance.
4. Hold the window-attention backward kernel against its plain PyTorch
   version (``window_attention_bwd_plain``) on the card at both production
   shapes and at ``CHECK_SHAPES``, in float32 (max abs err <= 1e-4) and
   bfloat16 (max abs err <= 2^-7 * max|ref| per output, compared in
   float32), on the forward phase's inputs (one window in eight fully
   masked) with g ~ N(0, 1): in fully masked windows dq = dk = 0 and dv is
   the mean of g. Time the kernel, the plain version and SDPA's backward
   (forward+backward through autograd minus forward; a yardstick only).
   Then both kernels, both dtypes, at the dense frame's occupancy (99% of
   the T=32 windows and 65% of the T=144 windows fully masked): checked
   against the plain versions and timed beside their bounds.
5. Train full-width SST through the port's training CLI (``tools/train.py
   sst``'s ``main``) on 3 file-backed synthetic frames at production scale
   (``write_synthetic_frames``: 120000 points, 40 boxes): 6 steps in
   bfloat16 (``--dtype bfloat16``), then 4 steps without ``--dtype``, in
   the detector's default float32, each under PyTorch's default TF32
   settings as the CLI's own process runs. The launch counts are set to 0
   just before and read after every step: each step must launch exactly 24
   forward and 24 backward kernels (12 per level). Every logged loss and
   ``grad_norm`` must be finite, the parameters must have moved, and a
   checkpoint must exist. Prints ms/step (median of the steps from the
   third on) and the peak memory, and each run's seconds.
6. One dense frame through ``SSTDetector.loss`` and backward in float32
   (TF32 off), at full width with the depth cut to 2 blocks (the time
   limit), with the kernels and with ``use_pallas_attention=False`` (the
   einsum differentiated by autograd), same weights: every parameter's
   gradient must agree within 1e-3 * its max |grad| + 1e-5 * the largest
   |grad| of the model (4 forward and 4 backward launches per level).
7. OcOccNet serving (predict, then the occupancy decode), full-width
   ``OcOccNetConfig()`` with seeded random weights on
   ``synthetic_batch(batch_size=4)``, through the ``ococcnet`` benchmark's
   functions: in bfloat16 in the packed layout (the config default) and in
   the dense layout (the ``roi_point_budget=640`` compaction); every output
   finite and of the JAX package's shapes (boxes [4, 32, 7], scores
   [4, 32], shape_latent [4, 32, 1536], occupancy logits [4, 32, 512]).
   No hand-written kernel lies on this path: the launch counts are set to
   0 before it and must read 0 after. Prints per layout the median ms per
   batch and tracklets/s, the decode ms and the peak memory; then float32
   (TF32 off) on the card against the port on the CPU (one tracklet, same
   weights) at a stated tolerance, and the largest bf16-vs-float32
   difference of the outputs, held to a stated tolerance too.
8. OcOccNet training at the full width of ``OcOccNetConfig()`` through the
   port's CLI (``tools/train.py ococcnet``'s ``main``) on 8 synthetic
   tracklets in the reference's layout (``write_synthetic_dataset``), batch
   4, in bfloat16 (``--dtype bfloat16``, the config's dropout on): 6 steps,
   then 2 more with ``--fixed-ae``. No hand-written kernel lies on this
   path (launches must read 0). Every logged loss and ``grad_norm`` must be
   finite, ``metrics.jsonl`` must hold every step, the parameters must
   have moved (under ``--fixed-ae`` all but ``ae_encoder``'s, which must
   not). Prints ms/step (median from the third step) and the peak memory
   with the card's name. Then one float32 step (TF32 off, dropout 0) of
   one tracklet on the card against the same step of the port on the CPU:
   the loss dict, ``grad_norm`` and every parameter after the update, each
   at a stated tolerance.
9. OcOccNet evaluation through the port's evaluation CLI
   (``tools/test.py ococcnet``'s ``main``) at full width (float32, the
   dense eval layout) on phase 8's checkpoint: its 8 tracklets of 40 frames
   (length bucket 64) and 2 more of 200 frames (bucket 256), plain with
   ``--occ-baseline``, with ``--tta`` and with ``--tune-steps 10``; then
   ``ctrl`` on a checkpoint of 2 ``tools/train.py ctrl`` steps, and
   ``tools/create_submission.py`` on a results ``.bin``. No hand-written
   kernel lies on this path (launches must read 0). The native metrics
   binary must print its mAP lines, each ``results.bin`` must hold one
   object per frame, and every occupancy metric must lie in [0, 1]. Prints
   per bucket the CLI's wall, the median ms per tracklet of predict,
   occupancy IoU, tuning and the baseline, and the peak memory.
10. One float32 ``Evaluator.run`` (TF32 off) of one 40-frame tracklet at
    full width on the card against the CPU, plain, with TTA and with 3
    tuning steps: boxes, scores and each frame's occupancy inter / union,
    each at the bar stated beside its constant.
11. SST evaluation through ``tools/test.py sst`` with ``--metric kitti``
    and ``--metric waymo`` on phase 5's float32 checkpoint (its
    classification bias lifted so that the decode keeps boxes) and frames:
    each frame must launch 12 forward kernels per level and no backward
    one. Prints the predict's ms per frame under the CLI.
12. CenterPoint inference at the full width of ``CenterPointConfig()``
    (float32, seeded random weights) on the dense and the sparse synthetic
    frame (150000 and 20000 points): outputs finite and of the predict
    shapes, the median ms per frame, the peak memory and the occupied
    voxels of each stage against its budget. No hand-written kernel lies on
    CenterPoint's path: the window-attention counts must read 0 after each
    CenterPoint phase.
13. One dense frame's head maps on the card against the port on the CPU,
    same weights, TF32 off and again under the CLI's settings (cuDNN
    convolutions in TF32), each at the bar stated beside its constant.
14. CenterPoint training through ``tools/train.py centerpoint``'s ``main``
    on phase 5's 3 frames: 4 float32 steps, finite losses, every parameter
    moved but the velocity branch's 3 (code weight 0), ms/step and the
    peak memory.
15. One float32 CenterPoint training step (TF32 off) of one dense frame on
    the card against the CPU, the card's ReLU routes fed to the CPU
    (``ops/routes.py``; at most ``CP_ROUTE_FLIPS`` of the fed elements
    differ from the CPU's own): the losses, every clipped gradient and
    every parameter after the update, at the bars beside their
    constants.
16. ``tools/test.py centerpoint`` with ``--metric kitti`` and ``--metric
    waymo`` on phase 14's checkpoint (its heatmap bias lifted so that the
    decode keeps boxes) and frames; the predict's ms per frame under the
    CLI.
17. FSD inference at the full width of ``FSDConfig()`` (float32 and
    bf16), FSDv2 (``use_clustering=False``, float32) and two-stage FSD
    (``TwoStageFSDConfig()``, float32), seeded random weights, on the dense
    and the sparse synthetic frame: predict shapes, finite where valid, the
    median ms per frame, the peak memory and the budgets' counts (UNet
    voxels per level; per class foreground points, cluster voxels and
    clusters). No hand-written kernel lies on the FSD family's path: the
    window-attention counts must read 0 after each FSD phase.
18. One dense frame of two-stage FSD, float32, TF32 off, card against the
    CPU: the segmentation at its bar; the grouping of each device on its
    own segmentation (the slots that differ, printed); stage 1's cluster
    forward and stage 2's outputs with both devices fed the card's grouping
    and pooled points, at the bars beside ``FSD_CPU_RTOL``.
19. ``tools/train.py fsd`` and ``fsd2``'s ``main`` on phase 5's 3 frames:
    4 float32 steps each, finite losses, every parameter moved but those of
    regression branches without positives (``FSD_REGRESSION``, listed),
    ms/step and the peak memory.
20. One float32 ``fsd2`` training step (TF32 off) card against CPU, both
    fed the card's grouping and pooled points: the losses, every clipped
    gradient and every parameter after the update, at phase 15's bars.
21. ``tools/test.py fsd`` and ``fsd2`` with ``--metric kitti`` and
    ``--metric waymo`` on phase 19's checkpoints (the seg head's class
    biases and the score biases lifted by ``FSD_EVAL_LIFT`` so that
    foreground and boxes survive the thresholds); the predict's ms per
    frame under the CLI.
22. FSD++ inference at the full width of ``FSDPPConfig()`` (two-stage,
    seeds, a memory of 320,000 points; float32, seeded random weights) over
    a sequence of 5 synthetic frames through ``benchmark fsdpp``
    (``make_sequential_predict_fn``), the memory carried: per frame the ms, the novel points, the valid
    memory points, the valid seeds, the memory points cropped by the seeds
    and the merged points kept, and the peak memory; predict shapes, finite
    where valid. No hand-written kernel lies on FSD++'s path: the
    window-attention counts must read 0 after each FSD++ phase.
23. A 3-frame float32 FSD++ sequence (TF32 off), card against CPU,
    teacher-forced: at each frame both devices get the card's incoming
    state, grouping and pooled points. The merged mask (novel points and
    the seed crop) and the memory update, as slots that differ, at most
    ``FSDPP_MASK_SLOTS``; the seeds the same way, at most
    ``FSDPP_SEED_SLOTS``; the outputs at phase 18's bars.
24. ``tools/train.py fsdpp``'s ``main`` on phase 5's 3 frames: 4 float32
    steps of windows of 2 frames, finite losses, every parameter moved but
    those of regression branches without positives, ms/step and the peak
    memory.
25. One float32 FSD++ window step (TF32 off) card against CPU, both fed
    the card's groupings and pooled points, the same offline seeds, the
    same seed-augmentation draws and the card's routes (``ops/routes.py``:
    the signs of the ReLU inputs, the rows that attain each max; the fed
    elements that differ from the CPU's own, at most ``FSDPP_ROUTE_FLIPS``
    of those fed): the losses, every clipped gradient and every parameter
    after the update, at phase 15's bars.
26. ``tools/test.py fsdpp`` with ``--metric kitti`` and ``--metric waymo``
    on phase 24's checkpoint (the seg head's class biases and stage 1's
    score biases, which the sequential evaluation reads, lifted by
    ``FSD_EVAL_LIFT``); the sequence step's ms per frame under the CLI.
27. W8: ``tools/train.py fsd2 --occ-pred-root`` for 4 float32 steps on
    phase 5's frames, with seeded ``[K, 4]`` occupancy files in
    ``save_occ``'s layout (``<root>/<segment>/<ts>/<type>_<id>.bin``, one
    per GT box) under each frame's segment and timestamp: the merged point
    counts, finite losses, ms/step.
28. W1: ``OccAnnotator`` at the size of ``tools/benchmark.py annotate``'s
    scene (``tools_occ/scenes.py::make_realistic_scene``: 100 frames of
    160,000 points and 150-400 on a car, five LiDARs, TOP 64 x 2650) on
    the card and on the CPU: the grids may differ only where the margin
    rule of ``tools_occ/annotate.py`` allows (a decision within 4 float32
    ulps of its boundary in a frame that decides the any; recomputed in
    float64 on the host); the same for the TOP LiDAR's visibility test of
    every voxel with its range images scaled by ``ANNOTATE_BLOCK_SCALE``
    (blocked and free voxels). Prints ms per tracklet with the host gather,
    the visibility test (device time by CUDA events) and the npz write,
    the peak memory, and 0 window-attention launches.
29. The data-prep CLI end to end: ``scenes.write_annotation_dataset``
    writes two segments of 10 ``write_synthetic_frames`` frames, their raw
    frame pkls (five LiDARs at Waymo's sizes) and GT / predicted tracklet
    ``.bin`` files (``evalx/waymo_bin.py``); ``tools/create_data.py
    occ_annotate --workers 2`` runs in subprocesses on the card and on the
    CPU (the npz files equal), then ``tracklets``; the tracklet dataset
    loads in ``TrackletDataset`` with the card's grids.
30. Augmented multi-sweep training: ``tools/train.py sst`` at
    ``SSTDetectorConfig()`` (float32) with ``--augment --gt-sample 2
    --num-sweeps 2 --disable-aug-after 2`` for 4 steps on phase 5's
    frames: points 6 wide (the VFE's first Dense 12 wide), 12 forward and
    12 backward launches per level per step, finite losses, augmentation
    and GT paste off from step 2 (counted from 0); prints each step's ms
    and the host ms per frame of augmentation and paste.
31. A, CTRL with the full segmentor (``ctrl_veh_config()`` with
    ``use_segmentor="full"``: 0.25 m voxels over +-100 m x +-10 m, 16,384
    voxels, VFE (64, 64), UNet (64, 64, 128)) on ``synthetic_batch(
    batch_size=4)`` (32 frames x 1,024 point slots per tracklet), packed:
    serving in float32 and bf16 (ms per batch, peak memory, the
    segmentor's voxels per tracklet against its budget); one tracklet's
    predict and float32 training step (TF32 off, dropout 0) card against
    CPU, the card's routes fed to the CPU, at phase 13's and phase 15's
    bars; then 3 steps of ``training/trainer.py::train`` on phase 8's
    tracklets (ms/step, peak memory); 0 window-attention launches.
32. B, the dense-layout float32 OcOccNet step (``roi_point_budget`` 640,
    TF32 off, dropout 0) with and without ``remat_sir``: every gradient
    within 1e-4; ms per step and the peak memory of each.
33. C, ``PrefetchLoader`` with 4 spawned workers: its first 2 batches equal
    a serial rebuild of its (index, seed) schedule; then ``python -m
    ...tools.train ococcnet`` at full width in bf16 with ``--loader-workers
    4`` and with the thread prefetcher, 6 steps each (ms/step from the
    third), beside the benchmark's step; each run a process of its own,
    killed with its workers if it has not ended within 300 s.
34. D, VoteNet at the full width of ``VoteNetConfig()`` (18 ScanNet
    classes, 40,000 points, SA 2048/1024/512/256, 1,024 seeds, 256
    proposals): ms per frame and per step, the peak memory, the kernels
    per frame and the furthest point samplings' host steps, kernels and
    ms (``benchmark votenet``); predict on a ScanNet and a SUN RGB-D scene
    (10 classes, yaw) card against CPU (float32, TF32 off) with the card's
    picks (samples, neighbours, ball memberships, through
    ``ops/routes.py::Routes``) fed to the CPU, the CPU's own differing in
    at most ``FSDPP_ROUTE_FLIPS`` of the fed elements, at phase 13's bar; ``tools/train.py
    votenet`` for 3 steps and ``tools/test.py votenet`` on written
    ScanNet and SUN RGB-D scenes of 50,000 points; 0 window-attention
    launches.
35. E, nuScenes frames (``write_nuscenes_frames``: 3 key frames of 30,000
    points with a sweep, inside SST's range): ``tools/train.py sst
    --dataset nuscenes`` for 2 float32 steps (12 forward and 12 backward
    launches per level per step) and ``tools/test.py sst --dataset
    nuscenes`` (12 forward per level per frame); one Lyft sample of the
    same files with its sweep.
36. Surgery: ``tools/publish_model.py publish`` of phase 8's checkpoint
    twice (the same ``-{hash8}`` name, no optimizer state); predict from
    ``restore_params`` equals the source checkpoint's bit for bit
    (deterministic kernels); ``transplant`` of phase 19's FSD ``vfe.`` and
    ``unet.`` into a one-step CTRL-with-segmentor checkpoint (the copied /
    missing / mismatch counts printed), then one CTRL step from it.
37. Serving: ``save_bundle`` of ``OcOccNetConfig()`` (float32) on the card
    in both layouts, ``load_bundle`` in a fresh process whose imports of
    the port's ``models``, ``ops`` and ``configs`` raise; served against
    live at ``FP32_OCC_CPU_ATOL``; the export's seconds, the bundle's MB,
    ms per batch of 4 served and live (the batch on the card for both),
    and a trace of each (kernels, device busy and wall ms per batch).
38. OcOccNet data-parallel, float32 (TF32 off, the config's dropout):
    (a) DDP in an NCCL group of one rank, (b) two ranks over gloo on
    ``cuda:0`` at batch 4 each, against the plain step at batch 8: losses
    and every parameter at phase 8's card bars; the ranks' parameters
    bit-equal; ms per step of each.
39. SST data-parallel, float32 (TF32 off): two ranks over gloo on
    ``cuda:0``, two dense frames each (the first under DDP's
    ``no_sync``), against one process on all four: every clipped gradient
    at phase 6's bars; 12 forward and 12 backward window-attention
    launches per level per frame and step on each rank.
40. Sharded evaluation: ``Evaluator.run`` of phase 8's checkpoint on two
    ranks (tracklets round-robin) against one process, deterministic
    kernels: ``results.bin`` is the shards' bytes in rank order, its
    objects the one process's as a multiset, every metric equal.
    Each run of 37-40 is a process group of its own, killed at
    ``RANK_WAIT`` s; one card's ranks measure the collectives' overhead,
    not scaling.
41. Tensor parallelism of OcOccNet's float32 step (phase 38's config,
    dropout and batch): (a) an NCCL group of one rank on a (1, 1) mesh,
    (b) two gloo ranks on ``cuda:0`` on a (1, 2) mesh, the 24 wide Dense
    kernels column-parallel; against phase 38's plain step at its bars,
    the ranks' whole parameters bit-equal; per rank ms per step, peak and
    the parameter, gradient and AdamW moment bytes.
42. FSDP, two gloo ranks on a (2, 1) mesh, half the batch each: the same
    bars and numbers, and the step's all-gather, reduce-scatter and
    all-reduce timed alone.
43. TP with sequence parallelism on a (1, 2) mesh (in 41 (b)'s
    processes): the same bars; the peak per rank against phase 38's.
44. ``tools/train.py ococcnet --tp 2 --fsdp --sequence-parallel`` in four
    gloo processes (mesh (2, 2)) and ``ctrl --tp 2`` in two, 3 steps on
    phase 8's tracklets, each against ``train`` in this process at the
    global batch: the logged losses and ``grad_norm``, the final
    checkpoint, restored in one process under its file's ``tree_hash``.
    Each run of 41-44 is a process group of its own, killed at
    ``RANK_WAIT`` s, and counts 0 window-attention launches on every
    rank.
45. CenterPoint with ``encoder_layout="column"`` at the full width of
    ``CenterPointConfig()`` on phase 12's dense and sparse frames and a
    near frame within every budget (``CP_NEAR``), float32 and the config's
    bf16 activations with remat: the occupied columns per stage against
    their budgets, ms per frame of each layout and dtype (the gather
    layout's beside them) and the peak memory; float32, TF32 off: the
    column head maps against the gather layout's on the same weights on
    every frame within every budget, and the dense frame card against CPU,
    at phase 13's bar.
46. Column-layout CenterPoint training through ``train_detector`` on
    phase 5's frames, ``CP_COLUMN_STEPS`` steps in bf16 and in float32:
    finite losses, ms/step and the peak memory beside phase 14's; one
    float32 column step card against CPU at phase 15's bars, the card's
    ReLU routes fed to the CPU (at most ``CP_ROUTE_FLIPS`` of them differ
    from the CPU's own).
47. OcOccNet's float32 step at phase 38's config and batch with the flat
    and the stacked optimizer layouts (``create_train_state(flat_opt= |
    stacked_opt=)``): every step's losses and ``grad_norm`` and the
    parameters after the first within phase 38's bars of its plain step;
    ms per step and the kernels per step and per clip and update
    (``torch.profiler``), the tree optimizer's beside them; then the flat
    layout on two gloo ranks on ``cuda:0`` (half the batch each), as phase
    38 (b) runs the tree: every step's losses and ``grad_norm`` and the
    parameters after the first within phase 38's bars of its plain step,
    the ranks' parameters bit-equal. Phases 45-47 count 0 window-attention
    launches.
48. The benchmark CLI on trained weights (``tools/benchmark.py``'s
    ``main`` with ``--ckpt-dir``, ``BENCH_CKPT_FRAMES`` timed calls at full
    width): ``ococcnet`` on phase 8's training checkpoint at ``--batch 2``
    and ``--batch 8`` and on phase 36's release at the default batch,
    ``sst --dtype float32`` on phase 5's float32 checkpoint,
    ``centerpoint`` on phase 14's and ``fsd`` on phase 19's. Each line's
    ``ckpt_step`` and ``params_hash`` must be those of the file it loaded
    (``surgery.tree_hash``), every output finite and of the predict
    shapes, OcOccNet's tracklets per call the ``--batch``; SST launches 12
    forward kernels per level per predict call and no backward one, the
    other families none. Prints ms per batch or frame with the card's name
    and power limit.
49. Print the kernels' JSON line (the bf16 and the float32 tensor-core
    kernels, each level apart; launches of the bf16 frames and bf16
    training, and of the float32 frame, float32, augmented, nuScenes and
    data-parallel training (both ranks), the SST evaluations and phase
    48's float32 SST benchmark), then as the last line ``{"ok": true,
    "device": {...}}``.

The Argoverse 2 reader needs pandas and pyarrow, which the card's machine
lacks: the CPU tests hold it, this script does not drive it.

It exits non-zero, printing no result, where ``torch.cuda.is_available()``
is false or the port's package is missing.
"""
import collections
import contextlib
import dataclasses
import glob
import inspect
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from objectcentricocccompletion_torch.configs.ococcnet_config import (
    OcOccNetConfig, ctrl_veh_config)
from objectcentricocccompletion_torch.data import frame_dataset as tfd
from objectcentricocccompletion_torch.data.indoor_dataset import (
    write_indoor_scenes)
from objectcentricocccompletion_torch.data.frame_dataset import (
    FrameDataset, write_synthetic_frames)
from objectcentricocccompletion_torch.data.loader import (
    PrefetchLoader, write_synthetic_dataset)
from objectcentricocccompletion_torch.data.nuscenes_dataset import (
    LyftDataset, write_nuscenes_frames)
from objectcentricocccompletion_torch.data.synthetic import synthetic_batch
from objectcentricocccompletion_torch.data.tracklet import TrackletBatch
from objectcentricocccompletion_torch.data.tracklet_dataset import (
    TrackletDataset)
from objectcentricocccompletion_torch.evalx import detector_eval, evaluator
from objectcentricocccompletion_torch.evalx.detector_eval import (
    make_predict_fn)
from objectcentricocccompletion_torch.evalx.submission import read_submission
from objectcentricocccompletion_torch.evalx.waymo_bin import read_bin
from objectcentricocccompletion_torch.models.centerpoint import (
    CenterPointConfig)
from objectcentricocccompletion_torch.models.fsd import FSD, Grouping
from objectcentricocccompletion_torch.models.fsd_two_stage import (
    two_stage_loss)
from objectcentricocccompletion_torch.models.fsdpp import SequenceState
from objectcentricocccompletion_torch.models.ococcnet import (
    OcOccNetWithLoss)
from objectcentricocccompletion_torch.models.sst_detector import SSTDetector
from objectcentricocccompletion_torch.ops import _build
from objectcentricocccompletion_torch.ops.routes import Routes
from objectcentricocccompletion_torch.ops import seeds as seed_ops
from objectcentricocccompletion_torch.ops import voxelize as vx
from objectcentricocccompletion_torch.parallel import collectives as cc
from objectcentricocccompletion_torch.parallel.train import (
    create_train_state, make_mesh_2d, make_train_step, shard_batch)
from objectcentricocccompletion_torch.ops import window_attention as wa
from objectcentricocccompletion_torch.tools import benchmark as bench
from objectcentricocccompletion_torch.tools import (
    create_submission as submission_cli)
from objectcentricocccompletion_torch.tools import test as test_cli
from objectcentricocccompletion_torch.tools import train as train_cli
from objectcentricocccompletion_torch.serving import save_bundle
from objectcentricocccompletion_torch.tools import (
    publish_model as publish_cli)
from objectcentricocccompletion_torch.training import surgery
from objectcentricocccompletion_torch.training.detector_trainer import (
    FrameBatch, make_detector_train_step, train_detector)
from objectcentricocccompletion_torch.training.optim import (
    BufferAdamW, clip_grad_global_norm_, make_optimizer)
from objectcentricocccompletion_torch.training.seq_trainer import (
    SeqWindow, make_seq_train_step)
from objectcentricocccompletion_torch.training.trainer import (
    CheckpointManager, train as train_tracklets)
from objectcentricocccompletion_torch.tools_occ import annotate, scenes
from objectcentricocccompletion_torch.utils.device import card_info

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; tensor-core
# FLOP/s; exp2 (16 per clock on each of 132 SMs at the 1.98 GHz boost clock).
# float32 products must keep float32's accuracy: one TF32 product keeps about
# 11 bits, three (3xTF32 on hi/lo splits) about 22, so the least time for
# them is three TF32 products at 494.7 TFLOP/s (the CUDA cores' float32 rate,
# 67 TFLOP/s, is slower still)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 494.7e12 / 3}
PEAK_EX2 = 16 * 132 * 1.98e9
# exponentials per (query, key, head) of the kernels (both dtypes): forward,
# backward
EX2_PER_PAIR = (1, 2)
ATTN_SHAPES = ((3200, 32), (800, 144))   # (W, T) of the two levels
C, H = 128, 8
# checked only (W, T, C, H): the tiny config (T=16, hd=8), hd=32, a ragged
# capacity (T=20, not a multiple of 16) and T=100
CHECK_SHAPES = ((64, 16, 32, 4), (64, 144, 128, 4), (64, 20, 128, 8),
                (64, 100, 128, 8))
# share of fully masked windows in the dense frame at each level (PERF.md
# section 4: 33 of 3,200 and 279 of 800 windows occupied)
MODEL_MASKED = ((3200, 32, 0.99), (800, 144, 0.65))
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# float32 sums in another order through 12 attention layers and the neck,
# on maps of magnitude ~10
FP32_MODEL_ATOL = 1e-4
# the float32 frame's depth: 2 of the SST's 6 blocks (the CPU forward of
# all 6 took most of the phase's 18 s; the bars above stay those of 6)
FP32_CHECK_BLOCKS = 2
# the same, plus cuDNN against oneDNN convolutions and GEMMs
FP32_CPU_ATOL = 1e-3
TIMED_FRAMES = 5
# backward kernel vs plain: float32 sums in another order over T keys
BWD_ATOL_FP32 = 1e-4
# bf16: one rounding of each output (8 bits) on values up to max|ref|
BWD_RTOL_BF16 = 2 ** -7
TRAIN_STEPS = {"bfloat16": 6, None: 4}   # per --dtype (None: the default)
TRAIN_TIMED_FROM = 3            # steps 1-2 build the model and warm up
# fp32 gradients, kernels vs einsum autograd, full width, depth cut to 2
# blocks: float32 sums in another order through 4 attention layers, the
# neck and the loss, per parameter; plus a floor on the model's largest
# gradient for the attention key biases, whose exact gradient is 0 (the
# softmax is invariant to them) and whose float32 values are noise
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-5
GRAD_CHECK_BLOCKS = 2
# OcOccNet serving: timed batches per layout (of bench.OCC_BATCH tracklets)
OCC_TIMED = 10
# float32 on the card against the CPU, OcOccNet: sums in another order
# (cuBLAS against oneDNN GEMMs, other erf / sin / exp) through 12 SIR
# blocks, 3 attention layers, the fusion MLPs and the 3-layer decoder; every
# layer ends in a LayerNorm, so the error stays near float32's 1e-7
# relative times the depth and the widths' sums, on O(1) outputs
FP32_OCC_CPU_ATOL = 1e-3
OCC_KEYS = ("cls_logit", "bbox_pred", "shape_latent", "occ_logits")
# bf16 against float32 on the card, the same weights and batch: bf16 keeps 8
# significant bits (2^-8 relative per rounding) and rounds every Dense's
# inputs and outputs through 12 SIR blocks, 3 attention layers and the
# decoder, on O(1) outputs; the CPU tests' bar against JAX bf16 (0.1), over
# twice the 0.0438 a full-width run of this check reads (PERF.md)
BF16_OCC_ATOL = 0.1
# float32 SST frame with cuDNN's convolutions in TF32 (the training CLI's
# settings) against the CPU: TF32 keeps a 10-bit mantissa, so each product
# in the neck's 3x3 convolutions (up to 1,152 terms) and the head's 1x1s
# carries a relative error near 2^-11; over sums of random sign and the
# neck's GroupNorms that is about 1e-3 of each layer's output, a few layers
# deep, on maps whose largest values are about 10 (PERF.md section 6)
FP32_TF32_CPU_ATOL = 3e-2
# OcOccNet training through the CLI: steps per run, timed from the third
OCC_TRAIN_STEPS = 6
OCC_FIXED_AE_STEPS = 2
OCC_TRAIN_TRACKLETS = 8
# one float32 training step on the card against the CPU, at lr 1e-3 so that
# the update shows: the loss dict (O(1)-O(10) values; the forward's 1e-3
# bar), grad_norm relative, every clipped gradient at the CPU tests' bar
# against JAX; then every parameter after AdamW's first step, which moves it
# by about lr in the sign of its gradient: where the CPU's gradient lies
# within the gradient bar of 0 the two signs may differ (2 lr apart),
# elsewhere the moves agree to far below 1e-3 lr; plus float32 rounding of
# O(1) weights
OCC_STEP_LR = 1e-3
OCC_STEP_LOSS_ATOL = 1e-3
OCC_STEP_GRAD_NORM_RTOL = 1e-3
OCC_STEP_GRAD_ATOL = 1e-4
OCC_STEP_ROUNDING = 1e-6
# OcOccNet / CTRL evaluation through tools/test.py: beside the training
# phase's 8 tracklets of 40 frames (bucket 64), 2 of 200 frames (bucket
# 256); the tuning steps of --tune-steps; CTRL's training steps
EVAL_LONG_TRACKLETS = 2
EVAL_LONG_FRAMES = 200
EVAL_TUNE_STEPS = 10
CTRL_TRAIN_STEPS = 2
# one float32 Evaluator.run (TF32 off) on the card against the CPU: the
# refined boxes come from the forward's O(1) residuals (its 1e-3 bar) times
# sizes of a few metres, so 1e-3 m; scores are sigmoids of logits within
# about 1e-4 of each other; the occupancy counts agree exactly except at
# probabilities within EVAL_NEAR of the threshold, whose side may differ
# (PERF.md section 6, written before the first run)
EVAL_BOX_ATOL = 1e-3
EVAL_SCORE_ATOL = 1e-4
EVAL_NEAR = 1e-4
EVAL_CHECK_TUNE_STEPS = 3
# added to the SST checkpoint's classification bias before its evaluation:
# the decode keeps boxes scored above 0.1, which a model trained for 4 steps
# from the prior's bias (sigmoid about 0.01) does not reach
SST_EVAL_CLS_LIFT = 3.0
# CenterPoint (float32 end to end, no hand-written kernel): timed frames per
# synthetic frame; card against CPU bars on the head's maps, each relative
# to max(1, the map's largest |value|), written in PERF.md before the first
# run. TF32 off: float32 sums in another order through the sparse
# encoder's gather-GEMMs and LayerNorms, 12 SECOND, 2 FPN and 3 head
# convolutions (up to 4,608 terms each), every layer renormalised
CP_TIMED_FRAMES = 5
CP_CPU_RTOL = 1e-3
# the CLI's settings: cuDNN's convolutions in TF32 (a 10-bit mantissa,
# about 3e-4 relative RMS per layer on sums of random sign), 17 dense
# convolution layers deep
CP_TF32_CPU_RTOL = 3e-2
CP_TRAIN_STEPS = 4
# one float32 step card against CPU (TF32 off): the losses at the forward's
# bar; each clipped gradient within 1e-3 of its tensor's largest |grad| plus
# 1e-5 of the model's largest (the SST gradient check's bar); the
# parameters after AdamW's first step at lr CP_STEP_LR as for OcOccNet: 2 lr
# apart where the CPU's gradient lies within its bar of 0, else 1e-3 lr,
# plus float32 rounding of O(1) weights
CP_STEP_LR = 1e-3
CP_STEP_LOSS_RTOL = 1e-3
CP_STEP_GRAD_RTOL = 1e-3
CP_STEP_GRAD_FLOOR = 1e-5
CP_STEP_ROUNDING = 1e-6
# added to the trained heatmap bias before the evaluation, as for SST
CP_EVAL_HM_LIFT = 3.0
CP_HEADS = ("heatmap", "reg", "height", "dim", "rot", "vel")
# the FSD family (no hand-written kernel; float32 unless --dtype): the
# inference variants (name, family, --dtype, use_clustering), timed frames
# per synthetic frame
FSD_VARIANTS = (("fsd float32", "fsd", None, True),
                ("fsd bfloat16", "fsd", "bfloat16", True),
                ("fsdv2 float32", "fsd", None, False),
                ("fsd2 float32", "fsd2", None, True))
FSD_TIMED_FRAMES = 5
# card against CPU, TF32 off, written in PERF.md before the first run:
# seg_logits and votes within FSD_CPU_RTOL of max(1, their largest |value|)
# (float32 sums in another order through the VFE, 9 sparse convolutions of
# up to 27 x 192 terms and the seg head, every layer renormalised); the
# cluster forward and the two-stage outputs, both devices fed the card's
# grouping and pooled points, within the same bar (3 SIR blocks, the
# 1024-wide shared MLP, 3 x 4 task heads, the RoI encoder and heads; sizes
# decode through exp)
FSD_CPU_RTOL = 1e-3
# decoded boxes and cluster centres, in metres up to 75 from the sensor:
# FSD_BOX_RTOL of their largest |value| (the centres are means of up to
# 4,096 vote-shifted points, summed in another order; float32's step at 75 m
# is 7.6e-6 m)
FSD_BOX_RTOL = 1e-4
FSD_CLUSTER_KEYS = ("cls", "reg_tasks")
FSD_BOX_KEYS = ("boxes_tasks", "cluster_centers")
FSD2_KEYS = ("cls2", "bbox2")
FSD_TRAIN_STEPS = 4
# one float32 fsd2 step card against CPU (TF32 off), both devices fed the
# card's grouping and pooled points: CenterPoint's bars (CP_STEP_*)
# the FSD parameters that a few steps on random weights may leave as they
# were: a regression branch with no positive (a task's centre / size /
# rotation MLPs, stage 2's conv_reg) gets no gradient, and its norms and
# biases take no weight decay
FSD_REGRESSION = ("_center.", "_dim.", "_rot.", "conv_reg.")
# added before the evaluation to the biases of the seg head's class logits
# (so that foreground survives seg_score_thresh after training) and of the
# scores (the FSD tasks' or stage 2's), so that boxes pass the decode's 0.1
FSD_EVAL_LIFT = 3.0
# FSD++ (no hand-written kernel; float32): the training CLI's full-width
# FSDPPConfig() over sequences of synthetic frames (seeds 0, 1, ...)
FSDPP_FRAMES = 5
FSDPP_CHECK_FRAMES = 3
# card against CPU, TF32 off, teacher-forced, written in PERF.md before the
# first run: the slots of the merged mask (novel current points and the seed
# crop) and of the memory update that differ, at most FSDPP_MASK_SLOTS (the
# voxel keys are exact float32 products and integer sorts on both devices;
# the crop's in-box test rotates by the seeds' yaw, whose sin and cos may
# differ in the last bit, for points within a rounding step of a face)
FSDPP_MASK_SLOTS = 8
# the seeds come from stage-2 scores that agree to FSD_CPU_RTOL: at most
# FSDPP_SEED_SLOTS of the 128 slots may differ in validity or label
# (neighbours in score order swap); boxes of the slots that agree at
# FSD_BOX_RTOL
FSDPP_SEED_SLOTS = 8
FSDPP_TRAIN_STEPS = 4
FSDPP_WINDOW = 2
# the FSD++ window step card against CPU is held to phase 15's bars with
# the card's routes fed to the CPU (ops/routes.py): two ReLU inputs after
# unet.down1's LayerNorm within a rounding step of 0 took opposite signs on
# the two devices and sent unet.down1's gradient 3.5 times over its bar;
# with the ReLU signs fed, a run sent a stage-1 head's gradient 1.01 times
# over (PERF.md section 6, FSD++). The fed elements that differ from the
# CPU's own route, at most this share of those fed (written before the
# first run that fed the signs)
FSDPP_ROUTE_FLIPS = 1e-5
# W8: predicted occupancy points per GT box in save_occ's layout, and steps
W8_OCC_ROWS = 512
W8_TRAIN_STEPS = 4
# W1: timed tracklets of the benchmark scene on the card (after one that
# stages the range images). Card against CPU: the margin rule of
# tools_occ/annotate.py (a voxel may differ only where a decision lies
# within 4 float32 ulps of its boundary in a frame that decides the any)
ANNOTATE_TIMED = 2
# the TOP LiDAR's range images scaled by this for a visibility check with
# blocked and free voxels (the benchmark scene's voxels are all free)
ANNOTATE_BLOCK_SCALE = 0.2
# the data-prep CLI's inputs: two segments of 10 frames, two car tracklets
# each, the five LiDARs at Waymo's sizes
ANNOTATE_DATA = dict(segments=2, frames_per_segment=10,
                     tracklets_per_segment=2, num_points=40000,
                     num_boxes=20)
CREATE_DATA_TIMEOUT = 300
# augmented multi-sweep SST training through the CLI
AUG_TRAIN_STEPS = 4
# A: CTRL with its full tracklet segmentor; timed serving batches, training
# steps through training/trainer.py::train
SEG_TIMED = 5
SEG_TRAIN_STEPS = 3
NO_DROPOUT = dict(occ_dropout=0.0, attn_dropout=0.0, cls_dropout=0.0,
                  reg_dropout=0.0, latent_dropout=0.0, fusion_dropout=0.0)
# B: the dense float32 step with and without remat_sir (timed steps)
REMAT_STEPS = 3
# C: the CLI with the worker pool against the thread prefetcher; the pool's
# first batches against a serial rebuild of its schedule
LOADER_WORKERS = 4
LOADER_STEPS = 6
LOADER_CHECK_BATCHES = 2
LOADER_WAIT = 300.0
# D: VoteNet at full width: timed frames / steps, written scenes, CLI steps
VOTE_TIMED = 5
VOTE_SCENES = 2
VOTE_TRAIN_STEPS = 3
# E: nuScenes frames for SST (inside its range), float32 CLI steps
NUS_FRAMES = 3
NUS_POINTS = 30000
NUS_TRAIN_STEPS = 2
AUG_ARGS = ("--augment", "--gt-sample", "2", "--num-sweeps", "2",
            "--disable-aug-after", "2")
# 36-40: every multi-rank run (and every process of a phase's own) is a
# process group of its own, killed at this many seconds
RANK_WAIT = 300.0
# steps of each data-parallel run: the first is compared, the rest timed
DDP_STEPS = 3
# phase 38's global batch (half on each of two ranks)
DDP_OCC_BATCH = 8
# phase 39's frames per rank of two (a rank's first frame under no_sync)
DDP_SST_FRAMES = 2
OCC_LOSSES = ("loss", "loss_rcnn_cls", "loss_rcnn_bbox", "loss_rcnn_occ")
# timed batches of a served bundle
SERVE_TIMED = 10
# 45: CenterPoint's column layout. Beside phase 12's dense and sparse
# frames, whose uniform clutter overflows the later stages' column budgets
# (and the gather layout's), a near frame that fits every budget of both
# layouts: 20,000 points of synth_frame seed 2 with x and y scaled by 0.1
# (within 7.5 m of the sensor). The column layout against the gather one
# and the card against the CPU at phase 13's bar, CP_CPU_RTOL
CP_NEAR = (20000, 2, 0.1)
CP_COLUMN_TIMED = 3             # timed frames per layout, dtype and frame
# 46: column-layout training steps through train_detector, each dtype;
# the float32 step card against CPU with the card's ReLU routes fed: the
# fed elements that differ from the CPU's own route, at most this share
CP_COLUMN_STEPS = 4
CP_ROUTE_FLIPS = 1e-5
# 47: traced steps and optimizer calls for the launch counts
OPT_TRACE_CALLS = 2
# phase 48: timed calls of each benchmark run on a checkpoint, and
# OcOccNet's tracklets per call at phase 8's training checkpoint
BENCH_CKPT_FRAMES = 3
BENCH_CKPT_BATCHES = (2, 8)


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps=20, warmup=3):
    """Median over ``reps`` calls of CUDA-event time, one call each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(W, T, C, dtype, gen, masked=None):
    """q/k/v ~ N(0, 1); per window a random token count in [1, T] at
    random positions; fully masked (unused slots): one window in eight, or
    a random ``masked`` share of the windows."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(W, T, C, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    count = torch.randint(1, T + 1, (W, 1), generator=gen, device=dev)
    rank = torch.rand(W, T, generator=gen, device=dev).argsort(-1)
    mask = rank < count
    if masked is None:
        mask[torch.arange(W, device=dev) % 8 == 7] = False
    else:
        empty = torch.randperm(W, generator=gen, device=dev)
        mask[empty[:round(masked * W)]] = False
    return q, k, v, mask.contiguous()


def attention_bound_ms(mask, C, dtype, backward=False):
    """The least time for the bytes the function must move and its
    products, on this mask. Every window reads the mask; the forward reads
    v and writes out, the backward reads g and writes dq, dk and dv; only a
    window with a valid key needs q and k (forward) or q, k and v
    (backward) and has products: 2 (forward) or 5 (backward) of 2*T^2*hd
    per head. A fully masked window's result has a closed form (the mean of
    v, or of g for dv; dq = dk = 0)."""
    W, T = mask.shape
    live = int(mask.any(1).sum())
    row_bytes = T * C * torch.finfo(dtype).bits // 8
    if backward:
        nbytes, flops = (4 * W + 3 * live) * row_bytes, 10 * live * T * T * C
    else:
        nbytes, flops = (2 * W + 2 * live) * row_bytes, 4 * live * T * T * C
    t_bytes = (nbytes + W * T) / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ex2_floor_ms(mask, H, backward=False):
    """The kernels' exponentials (one per query, key and head of every
    window with a valid key in the forward, two in the backward) at the
    card's exp2 rate: a floor beside the bound."""
    W, T = mask.shape
    live = int(mask.any(1).sum())
    return live * H * T * T * EX2_PER_PAIR[backward] / PEAK_EX2 * 1e3


def check_against_plain(W, T, C, H, dtype, gen, masked=None):
    """Kernel vs plain on one random input; returns the inputs and errors
    (all keys, and fully masked windows against the mean of v)."""
    q, k, v, mask = attention_inputs(W, T, C, dtype, gen, masked)
    out = wa.window_attention(q, k, v, mask, H)
    torch.cuda.synchronize()
    ref = wa.window_attention_plain(q, k, v, mask, H)
    err = (out.float() - ref.float()).abs().max().item()
    full = ~mask.any(1)
    mean_v = v[full].float().mean(1, keepdim=True)
    err_full = (out[full].float() - mean_v).abs().max().item()
    if not (err <= ATOL[dtype] and err_full <= ATOL[dtype]):
        raise AssertionError(f"kernel vs plain W={W} T={T} C={C} H={H} "
                             f"{dtype}: max abs err {err}, fully masked "
                             f"{err_full}, tolerance {ATOL[dtype]}")
    return (q, k, v, mask), err, err_full


def phase_kernel_vs_plain():
    gen = torch.Generator(device="cuda").manual_seed(0)
    for W, T, c, h in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            _, err, err_full = check_against_plain(W, T, c, h, dtype, gen)
            log(f"attention W={W} T={T} C={c} H={h} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (fully masked {err_full:.3e})")
    rows = {}
    for W, T in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            (q, k, v, mask), err, err_full = check_against_plain(
                W, T, C, H, dtype, gen)
            ms = median_ms(lambda: wa.window_attention(q, k, v, mask, H))
            plain_ms = median_ms(
                lambda: wa.window_attention_plain(q, k, v, mask, H))
            hd = C // H
            q4, k4, v4 = (x.view(W, T, H, hd).transpose(1, 2).contiguous()
                          for x in (q, k, v))
            m4 = mask[:, None, None, :]
            library_ms = median_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=m4))
            bound_ms, bound_by = attention_bound_ms(mask, C, dtype)
            rows[(T, dtype)] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=library_ms)
            log(f"attention W={W} T={T} {str(dtype)[6:]}: max_abs_err "
                f"{err:.3e} (fully masked {err_full:.3e}) kernel {ms:.4f} ms"
                f" plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms bound "
                f"{bound_ms:.4f} ms ({bound_by}) ex2 floor "
                f"{ex2_floor_ms(mask, H):.4f} ms; occupied tokens "
                f"{mask.float().mean().item():.3f}")
    return rows


def check_bwd_against_plain(W, T, C, H, dtype, gen, masked=None):
    """Backward kernel vs plain on one random input; returns the inputs
    and the largest error over dq, dk, dv (each against its tolerance)."""
    q, k, v, mask = attention_inputs(W, T, C, dtype, gen, masked)
    g = torch.randn(W, T, C, generator=gen, device="cuda").to(dtype)
    got = wa._bwd_kernel(q, k, v, mask, g, H)
    torch.cuda.synchronize()
    ref = wa.window_attention_bwd_plain(q, k, v, mask, g, H)
    full = ~mask.any(1)
    mean_g = g[full].float().mean(1, keepdim=True)
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        a, b = a.float(), b.float()
        tol = (BWD_ATOL_FP32 if dtype == torch.float32
               else BWD_RTOL_BF16 * b.abs().max().item())
        err = (a - b).abs().max().item()
        # fully masked windows: dq = dk = 0 exactly, dv = the mean of g
        err_full = (a[full].abs().max().item() if name != "dv" else
                    (a[full] - mean_g).abs().max().item())
        if not (err <= tol and err_full <= tol):
            raise AssertionError(
                f"backward kernel vs plain {name} W={W} T={T} C={C} H={H} "
                f"{dtype}: max abs err {err}, fully masked {err_full}, "
                f"tolerance {tol}")
        worst = max(worst, err)
    return (q, k, v, mask, g), worst


def sdpa_bwd_ms(q, k, v, mask, g, H):
    """SDPA's backward with the boolean mask: forward+backward through
    autograd minus the forward alone (a yardstick; the port never calls
    it)."""
    W, T, c = q.shape
    hd = c // H
    q4, k4, v4, g4 = (x.view(W, T, H, hd).transpose(1, 2).contiguous()
                      for x in (q, k, v, g))
    q4, k4, v4 = (x.requires_grad_() for x in (q4, k4, v4))
    m4 = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd():
        with torch.no_grad():
            sdpa(q4, k4, v4, attn_mask=m4)

    def fwd_bwd():
        torch.autograd.grad(sdpa(q4, k4, v4, attn_mask=m4), (q4, k4, v4),
                            g4)
    return median_ms(fwd_bwd) - median_ms(fwd)


def phase_bwd_kernel_vs_plain():
    gen = torch.Generator(device="cuda").manual_seed(1)
    for W, T, c, h in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            _, err = check_bwd_against_plain(W, T, c, h, dtype, gen)
            log(f"attention bwd W={W} T={T} C={c} H={h} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e}")
    rows = {}
    for W, T in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            (q, k, v, mask, g), err = check_bwd_against_plain(
                W, T, C, H, dtype, gen)
            ms = median_ms(lambda: wa._bwd_kernel(q, k, v, mask, g, H))
            plain_ms = median_ms(
                lambda: wa.window_attention_bwd_plain(q, k, v, mask, g, H))
            library_ms = sdpa_bwd_ms(q, k, v, mask, g, H)
            bound_ms, bound_by = attention_bound_ms(mask, C, dtype,
                                                    backward=True)
            rows[(T, dtype)] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=library_ms)
            log(f"attention bwd W={W} T={T} {str(dtype)[6:]}: max_abs_err "
                f"{err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"sdpa bwd {library_ms:.4f} ms bound {bound_ms:.4f} ms "
                f"({bound_by}) ex2 floor "
                f"{ex2_floor_ms(mask, H, backward=True):.4f} ms")
    return rows


def phase_model_occupancy():
    """Both kernels at the dense frame's share of fully masked windows:
    checked against the plain versions, and timed beside their bounds."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for W, T, share in MODEL_MASKED:
        for dtype in (torch.float32, torch.bfloat16):
            (q, k, v, mask), _, _ = check_against_plain(W, T, C, H, dtype,
                                                        gen, share)
            fwd_ms = median_ms(lambda: wa._fwd_kernel(q, k, v, mask, H))
            fb, fby = attention_bound_ms(mask, C, dtype)
            fex = ex2_floor_ms(mask, H)
            (q, k, v, mask, g), _ = check_bwd_against_plain(W, T, C, H, dtype,
                                                            gen, share)
            bwd_ms = median_ms(lambda: wa._bwd_kernel(q, k, v, mask, g, H))
            bb, bby = attention_bound_ms(mask, C, dtype, backward=True)
            log(f"attention at the model's occupancy W={W} T={T} "
                f"{str(dtype)[6:]}: {int((~mask.any(1)).sum())} windows "
                f"fully masked; forward {fwd_ms:.4f} ms (bound {fb:.4f} ms "
                f"{fby}, ex2 floor {fex:.4f} ms), backward {bwd_ms:.4f} ms "
                f"(bound {bb:.4f} ms {bby}, ex2 floor "
                f"{ex2_floor_ms(mask, H, backward=True):.4f} ms)")


def occupancy(model, points, mask):
    """Occupied windows per (shift, level) and voxels in the frame."""
    c = model.cfg.sst
    vres = vx.voxelize(points, mask, c.voxel_size, c.pc_range, c.max_voxels)
    shifts = model.backbone.partitions(vres)
    occ = {f"shift{s}_T{lv.mask.shape[1]}": int(lv.part.num_windows)
           for s, shift in enumerate(shifts) for lv in shift.levels}
    occ["voxels"] = int(vres.num_voxels)
    return occ


def check_predict(result, max_out=500):
    boxes, scores, labels, valid = result
    shapes = [tuple(x.shape) for x in result]
    if shapes != [(max_out, 7), (max_out,), (max_out,), (max_out,)]:
        raise AssertionError(f"predict shapes {shapes}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("predict outputs are not finite")
    return int(valid.sum())


def phase_inference(dev):
    cfg = bench.sst_config("bfloat16")
    model = bench.build_sst(cfg, dev, seed=0)
    predict = make_predict_fn(model, "sst")
    frames = {"dense": bench.frame_tensors(cfg, dev, 150000, seed=0),
              "sparse": bench.frame_tensors(cfg, dev, 20000, seed=1)}
    for name, (pts, msk) in frames.items():
        log(f"frame {name}: windows per level {occupancy(model, pts, msk)}")
        check_predict(predict(pts, msk))          # warm-up
    torch.cuda.synchronize()

    per_frame = len(model.backbone.layers)        # one launch per level
    wa.LAUNCHES.clear()
    results = {}
    for name, (pts, msk) in frames.items():
        before = dict(wa.LAUNCHES)
        n_valid = check_predict(predict(pts, msk))
        torch.cuda.synchronize()
        delta = {t: wa.LAUNCHES[t] - before.get(t, 0) for t in wa.LAUNCHES}
        if delta != {32: per_frame, 144: per_frame}:
            raise AssertionError(f"frame {name}: launches {delta}, expected "
                                 f"{per_frame} per level")
        times = bench.time_frames(predict, pts, msk, TIMED_FRAMES, warmup=0)
        results[name] = statistics.median(times)
        log(f"frame {name}: bf16 predict {results[name]:.3f} ms/frame "
            f"(median of {TIMED_FRAMES}: {[round(t, 3) for t in times]}), "
            f"{n_valid} boxes over the score threshold")
    launches = dict(wa.LAUNCHES)
    total = 2 * (1 + TIMED_FRAMES)
    if launches != {32: per_frame * total, 144: per_frame * total}:
        raise AssertionError(f"main path launches {launches}")
    log(f"main path: {total} frames, kernel launches {launches} "
        f"({2 * per_frame} per frame)")

    # the same bf16 model with the plain attention, for the end-to-end
    # share of the kernel
    plain_cfg = dataclasses.replace(cfg, sst=dataclasses.replace(
        cfg.sst, use_pallas_attention=False))
    plain = SSTDetector(plain_cfg, device=dev)
    plain.load_state_dict(model.state_dict())
    plain_pred = make_predict_fn(plain.eval(), "sst")
    pts, msk = frames["dense"]
    plain_ms = statistics.median(bench.time_frames(plain_pred, pts, msk,
                                                   TIMED_FRAMES))
    log(f"frame dense: bf16 predict with the plain attention "
        f"{plain_ms:.3f} ms/frame")
    return launches, results


def compare_maps(what, got, ref, atol):
    for key in ("cls", "reg", "dir"):
        if not torch.isfinite(got[key]).all():
            raise AssertionError(f"{what}: {key} not finite")
        err = (got[key] - ref[key].to(got[key].device)).abs().max().item()
        log(f"{what}: {key} max abs err {err:.3e} (tolerance {atol}; "
            f"magnitude {ref[key].abs().max().item():.3f})")
        if not err <= atol:
            raise AssertionError(f"{what} {key}: {err} > {atol}")


def phase_fp32_model_check(dev):
    """One dense frame in float32 (TF32 off): the kernel model against the
    same weights with the plain attention on the card, and against the CPU
    run of the port (the path the CPU tests hold to the JAX package); then
    the kernel model under the training CLI's TF32 settings against the
    same CPU run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench.sst_config("float32")
    cfg = dataclasses.replace(cfg, sst=dataclasses.replace(
        cfg.sst, num_blocks=FP32_CHECK_BLOCKS))
    kern = bench.build_sst(cfg, dev, seed=0)
    plain_cfg = dataclasses.replace(cfg, sst=dataclasses.replace(
        cfg.sst, use_pallas_attention=False))
    plain = SSTDetector(plain_cfg, device=dev).eval()
    plain.load_state_dict(kern.state_dict())
    cpu = SSTDetector(cfg, device="cpu").eval()
    cpu.load_state_dict(kern.state_dict())
    pts, msk = bench.frame_tensors(cfg, dev, 150000, seed=0)
    with torch.inference_mode():
        wa.LAUNCHES.clear()
        a = kern(pts, msk)
        torch.cuda.synchronize()
        launches = dict(wa.LAUNCHES)
        b = plain(pts, msk)
        c = cpu(pts.cpu(), msk.cpu())
    per_level = len(kern.backbone.layers)
    if launches != {32: per_level, 144: per_level}:
        raise AssertionError(f"fp32 frame: forward launches {launches}, "
                             f"expected {per_level} per level")
    compare_maps("fp32 model, kernel vs plain attention", a, b,
                 FP32_MODEL_ATOL)
    compare_maps("fp32 model, card vs CPU", a, c, FP32_CPU_ATOL)
    torch.backends.cudnn.allow_tf32 = True
    with torch.inference_mode():
        wa.LAUNCHES.clear()
        d = kern(pts, msk)
        torch.cuda.synchronize()
    if dict(wa.LAUNCHES) != launches:
        raise AssertionError(f"fp32 frame under TF32: launches "
                             f"{dict(wa.LAUNCHES)}, expected {launches}")
    compare_maps("fp32 model under the CLI's TF32 settings (cuDNN TF32 on, "
                 "matmul TF32 off), card vs CPU", d, c, FP32_TF32_CPU_ATOL)
    torch.backends.cudnn.allow_tf32 = False
    return launches


def phase_training(dev, dtype, keep=None):
    """Full-width training through the port's CLI, with ``--dtype dtype``
    or, for None, without it (the detector's default float32); returns the
    launch counts of the run (forward, backward). With ``keep`` the frames
    (``keep/frames``) and the work directory (``keep/work``) stay there."""
    steps = TRAIN_STEPS[dtype]
    name = dtype or "float32 (default dtype)"
    per_level = 2 * bench.sst_config().sst.num_blocks   # one per layer
    expect = {32: per_level, 144: per_level}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = keep or tmp
        data = os.path.join(tmp, "frames")
        t = time.perf_counter()
        infos = write_synthetic_frames(data, num_frames=3, num_points=120000,
                                       num_boxes=40, seed=0)
        log(f"training: wrote 3 synthetic frames in "
            f"{time.perf_counter() - t:.1f} s")
        work = os.path.join(tmp, "work")
        steps_seen = []

        def hook(step, metrics):
            torch.cuda.synchronize()
            steps_seen.append((step, time.perf_counter(), dict(wa.LAUNCHES),
                               dict(wa.BWD_LAUNCHES)))

        argv = ["sst", "--infos", infos, "--data-root", data, "--total-steps",
                str(steps), "--log-interval", "1", "--work-dir", work,
                "--device", "cuda", "--seed", "0"]
        if dtype:
            argv += ["--dtype", dtype]
        # as the CLI's own process runs: PyTorch's defaults (cuDNN may use
        # TF32, matmuls may not), which the float32 checks turned off
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        t0 = time.perf_counter()
        done = train_cli.main(argv, hooks=[hook])
        fwd, bwd = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if done != steps or len(steps_seen) != steps:
            raise AssertionError(f"{name} training ran {len(steps_seen)} "
                                 f"steps")
        prev = (t0, {}, {})
        times = []
        for step, now, f, b in steps_seen:
            df = {T: n - prev[1].get(T, 0) for T, n in f.items()}
            db = {T: n - prev[2].get(T, 0) for T, n in b.items()}
            if df != expect or db != expect:
                raise AssertionError(f"{name} training step {step}: forward "
                                     f"launches {df}, backward {db}, "
                                     f"expected {expect} each")
            times.append((now - prev[0]) * 1e3)
            prev = (now, f, b)
        rows = [json.loads(line) for line in
                open(os.path.join(work, "metrics.jsonl"))]
        keys = ("loss", "loss_cls", "loss_bbox", "loss_dir", "grad_norm")
        if [r["step"] for r in rows] != list(range(1, steps + 1)) or \
                not all(abs(r[k]) < float("inf") for r in rows for k in keys):
            raise AssertionError(f"{name} training metrics {rows}")
        for r in rows:
            log(f"training {name} step " + " ".join(
                f"{k}={r[k]}" for k in ("step",) + keys + ("num_pos_anchors",
                                                           "frames_per_sec")))
        ckpt = os.path.join(work, "ckpt", f"step_{steps}.pt")
        if not os.path.exists(ckpt):
            raise AssertionError(f"no checkpoint at {ckpt}")
        trained = torch.load(ckpt, map_location="cpu",
                             weights_only=True)["model"]
    # the CLI's init: the same config and seed, on the CPU
    init = SSTDetector(train_cli.sst_train_config(dtype=dtype), "cpu",
                       torch.Generator().manual_seed(0)).state_dict()
    # the attention key biases may stay: their exact gradient is 0 (the
    # softmax is invariant to them) and biases take no weight decay
    same = [n for n, p in init.items() if torch.equal(p, trained[n])]
    if any(not n.endswith(".k.bias") for n in same):
        raise AssertionError(f"parameters did not move: {same}")
    timed = times[TRAIN_TIMED_FROM - 1:]
    step_ms = statistics.median(timed)
    log(f"training: {steps} {name} steps at full width, "
        f"{step_ms:.3f} ms/step (median of steps {TRAIN_TIMED_FROM}-"
        f"{steps}: {[round(x, 3) for x in timed]}; all "
        f"{[round(x, 3) for x in times]}), peak memory {peak_gib:.3f} GiB, "
        f"launches forward {fwd} backward {bwd}, "
        f"{len(init) - len(same)} of {len(init)} parameter tensors moved; "
        f"card {card_info()}")
    return fwd, bwd


def phase_fp32_grad_check(dev):
    """Gradients of one dense frame's loss in float32, the kernels against
    the einsum autograd, at full width with the depth cut."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench.sst_config("float32")
    cfg = dataclasses.replace(cfg, sst=dataclasses.replace(
        cfg.sst, num_blocks=GRAD_CHECK_BLOCKS))
    kern = bench.build_sst(cfg, dev, seed=0).train()
    plain = SSTDetector(dataclasses.replace(cfg, sst=dataclasses.replace(
        cfg.sst, use_pallas_attention=False)), device=dev).train()
    plain.load_state_dict(kern.state_dict())
    b = bench.train_batch(cfg, dev, 150000, seed=0)
    frame = [x[0] for x in b]
    grads, losses = [], []
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    for model in (kern, plain):
        out = model.loss(*frame)
        out["loss"].backward()
        losses.append(out["loss"].item())
        grads.append({n: p.grad for n, p in model.named_parameters()})
    fwd, bwd = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
    per_level = len(kern.backbone.layers)
    if fwd != {32: per_level, 144: per_level} or bwd != fwd:
        raise AssertionError(f"fp32 gradient check: launches forward {fwd} "
                             f"backward {bwd}, expected {per_level} per "
                             f"level each")
    scale = max(g.abs().max().item() for g in grads[1].values())
    worst = (0.0, "")
    for n, ref in grads[1].items():
        err = (grads[0][n] - ref).abs().max().item()
        tol = GRAD_RTOL * ref.abs().max().item() + GRAD_FLOOR * scale
        if not err <= tol:
            raise AssertionError(f"fp32 gradient {n}: kernels vs einsum "
                                 f"max abs err {err} > {tol}")
        worst = max(worst, (err / tol, n))
    log(f"fp32 gradients ({GRAD_CHECK_BLOCKS} blocks, full width): loss "
        f"{losses[0]:.6f} (kernels) vs {losses[1]:.6f} (einsum); "
        f"{len(grads[1])} parameters within tolerance, worst {worst[1]} at "
        f"{worst[0]:.3f} of it; largest |grad| {scale:.3e}; launches "
        f"forward {fwd} backward {bwd}")


def serve(model, batch, queries):
    """OcOccNet predict, then the occupancy decode of ``queries``."""
    with torch.inference_mode():
        out = model.predict(batch)
        out["occ_logits"] = model.decode_occ_queries(out["shape_latent"],
                                                      queries)
    return out


def ococc_shapes(cfg, B):
    """The JAX package's shapes of OcOccNet's predict and occupancy decode
    for ``B`` tracklets."""
    L, D, K = cfg.reg_len, cfg.d_model, cfg.num_occ_samples
    return {"boxes": (B, L, 7), "scores": (B, L), "cls_logit": (B, L),
            "bbox_pred": (B, L, 7), "shape_latent": (B, L, D),
            "ae_latent": (B, L, D), "nonempty": (B, L),
            "occ_logits": (B, L, K)}


def check_ococc(what, out, cfg, B):
    """The JAX package's shapes, and every output finite."""
    expect = ococc_shapes(cfg, B)
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != expect:
        raise AssertionError(f"{what}: shapes {shapes}, expected {expect}")
    bad = [k for k, v in out.items()
           if v.is_floating_point() and not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"{what}: not finite: {bad}")


def phase_ococcnet(dev):
    """Full-width OcOccNet serving in bf16 (packed and dense layouts),
    float32 on the card against the CPU, and bf16 against float32."""
    card = card_info()
    bf16 = {}
    for layout in bench.LAYOUTS:
        cfg = bench.ococcnet_config("bfloat16", layout)
        if layout == "packed":
            model = bench.build_ococcnet(cfg, dev, seed=0)
            weights = model.state_dict()
        else:                       # the same weights, another layout
            model = OcOccNetWithLoss(cfg, device=dev).eval()
            model.load_state_dict(weights)
        b, q = bench.tracklet_batch(cfg, dev, bench.OCC_BATCH, seed=0)
        serve(model, b, q)                              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        out = serve(model, b, q)
        torch.cuda.synchronize()
        launched = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
        if any(launched):
            raise AssertionError(f"ococcnet {layout}: hand-written kernels "
                                 f"launched {launched}; the path has none")
        check_ococc(f"ococcnet bf16 {layout}", out, cfg, bench.OCC_BATCH)
        bf16[layout] = out
        with torch.inference_mode():
            times = bench.time_calls(lambda: model.predict(b), OCC_TIMED,
                                     dev, warmup=0)
            dec = bench.time_calls(lambda: model.decode_occ_queries(
                out["shape_latent"], q), OCC_TIMED, dev, warmup=0)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        ms = statistics.median(times)
        kept = int(out["nonempty"].sum())
        log(f"ococcnet bf16 {layout}: predict {ms:.3f} ms/batch of "
            f"{bench.OCC_BATCH} tracklets x {cfg.reg_len} frames (median "
            f"of {OCC_TIMED}: {[round(t, 3) for t in times]})")
        log(f"ococcnet bf16 {layout}: {bench.OCC_BATCH * 1e3 / ms:.2f} "
            f"tracklets/s")
        log(f"ococcnet bf16 {layout}: occupancy decode "
            f"{statistics.median(dec):.3f} ms/batch ({q.shape[2]} queries "
            f"per frame)")
        log(f"ococcnet bf16 {layout}: peak memory {peak:.3f} GiB; "
            f"{kept} of {out['nonempty'].numel()} frames hold points; "
            f"hand-written kernel launches 0; card {card}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst_bf16 = {}
    for layout in bench.LAYOUTS:
        cfg = bench.ococcnet_config("float32", layout)
        m32 = OcOccNetWithLoss(cfg, device=dev).eval()
        m32.load_state_dict(weights)
        b, q = bench.tracklet_batch(cfg, dev, bench.OCC_BATCH, seed=0)
        out = serve(m32, b, q)
        check_ococc(f"ococcnet fp32 {layout}", out, cfg, bench.OCC_BATCH)
        cpu = OcOccNetWithLoss(cfg, device="cpu").eval()
        cpu.load_state_dict(weights)
        one = TrackletBatch(*(x[:1].cpu() for x in b))
        ref = serve(cpu, one, q[:1].cpu())
        for k in OCC_KEYS:
            err = (out[k][:1].cpu() - ref[k]).abs().max().item()
            log(f"ococcnet fp32 {layout}, card vs CPU (1 tracklet): {k} max "
                f"abs err {err:.3e} (tolerance {FP32_OCC_CPU_ATOL}; "
                f"magnitude {ref[k].abs().max().item():.3f})")
            if not err <= FP32_OCC_CPU_ATOL:
                raise AssertionError(f"ococcnet fp32 {layout} card vs CPU "
                                     f"{k}: {err} > {FP32_OCC_CPU_ATOL}")
            worst_bf16[(layout, k)] = (
                bf16[layout][k].float() - out[k]).abs().max().item()
    for (layout, k), err in worst_bf16.items():
        log(f"ococcnet {layout}: bf16 vs fp32 {k} max abs diff {err:.4f} "
            f"(tolerance {BF16_OCC_ATOL})")
    log(f"ococcnet: largest bf16 vs fp32 output difference "
        f"{max(worst_bf16.values()):.4f}")
    bad = {lk: err for lk, err in worst_bf16.items()
           if not err <= BF16_OCC_ATOL}
    if bad:
        raise AssertionError(f"ococcnet bf16 vs fp32 beyond {BF16_OCC_ATOL}: "
                             f"{bad}")


def ococc_cli_run(dev, paths, work, steps, extra=()):
    """``tools/train.py ococcnet`` on the synthetic tracklets at full width
    in bf16; returns each step's ms, the trained weights and the peak
    GiB."""
    argv = ["ococcnet", "--proposals", paths["proposals_file"],
            "--gt-candidates", paths["gt_candidates_file"], "--poses",
            paths["pose_file"], "--occ-root", paths["occ_anno_root"],
            "--total-steps", str(steps), "--log-interval", "1",
            "--work-dir", work, "--device", "cuda", "--seed", "0",
            "--dtype", "bfloat16", *extra]
    stamps = []

    def hook(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats(dev)
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    t0 = time.perf_counter()
    done = train_cli.main(argv, hooks=[hook])
    launched = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
    if done != steps or len(stamps) != steps:
        raise AssertionError(f"ococcnet training ran {len(stamps)} steps")
    if any(launched):
        raise AssertionError(f"ococcnet training: hand-written kernels "
                             f"launched {launched}; the path has none")
    times = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    rows = [json.loads(line)
            for line in open(os.path.join(work, "metrics.jsonl"))]
    keys = ("loss", "loss_rcnn_cls", "loss_rcnn_bbox", "loss_rcnn_occ",
            "grad_norm")
    if [r["step"] for r in rows] != list(range(1, steps + 1)) or \
            not all(abs(r[k]) < float("inf") for r in rows for k in keys):
        raise AssertionError(f"ococcnet training metrics {rows}")
    for r in rows:
        log("ococcnet training step " + " ".join(
            f"{k}={r[k]}" for k in ("step",) + keys + (
                "num_pos_rois", "lr", "tracklets_per_sec")))
    trained = torch.load(os.path.join(work, "ckpt", f"step_{steps}.pt"),
                         map_location="cpu", weights_only=True)["model"]
    return times, trained, torch.cuda.max_memory_allocated(dev) / 2 ** 30


def phase_ococc_training(dev, keep=None):
    """Full-width OcOccNet training through the CLI in bf16, then
    ``--fixed-ae``. With ``keep`` the tracklets (``keep/data``) and the
    first run's work directory (``keep/work``) stay there."""
    cfg = train_cli.ococc_train_config(dtype="bfloat16")
    init = OcOccNetWithLoss(cfg, "cpu",
                            torch.Generator().manual_seed(0)).state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = keep or tmp
        paths = write_synthetic_dataset(os.path.join(tmp, "data"),
                                        num_tracklets=OCC_TRAIN_TRACKLETS,
                                        seed=0)
        times, trained, peak = ococc_cli_run(
            dev, paths, os.path.join(tmp, "work"), OCC_TRAIN_STEPS)
        # the attention key biases may stay: their exact gradient is 0 (the
        # softmax is invariant to them) and biases take no weight decay
        same = [n for n, p in init.items() if torch.equal(p, trained[n])]
        if any(not n.endswith(".k.bias") for n in same):
            raise AssertionError(f"ococcnet parameters did not move: {same}")
        timed = times[TRAIN_TIMED_FROM - 1:]
        step_ms = statistics.median(timed)
        log(f"ococcnet training: {OCC_TRAIN_STEPS} bf16 steps at full width,"
            f" batch {cfg.batch_size}, {step_ms:.3f} ms/step (median of "
            f"steps {TRAIN_TIMED_FROM}-{OCC_TRAIN_STEPS}: "
            f"{[round(x, 3) for x in timed]}; all "
            f"{[round(x, 3) for x in times]}), "
            f"{cfg.batch_size * 1e3 / step_ms:.2f} tracklets/s, peak memory "
            f"{peak:.3f} GiB, {len(init) - len(same)} of {len(init)} "
            f"parameter tensors moved; card {card_info()}")
        _, frozen, _ = ococc_cli_run(dev, paths,
                                     os.path.join(tmp, "work_fixed_ae"),
                                     OCC_FIXED_AE_STEPS, ["--fixed-ae"])
    moved_ae = [n for n, p in init.items()
                if ".ae_encoder." in n and not torch.equal(p, frozen[n])]
    same = [n for n, p in init.items() if ".ae_encoder." not in n
            and torch.equal(p, frozen[n]) and not n.endswith(".k.bias")]
    if moved_ae or same:
        raise AssertionError(f"--fixed-ae: ae_encoder moved {moved_ae}, "
                             f"others did not {same}")
    log(f"ococcnet training --fixed-ae: {OCC_FIXED_AE_STEPS} steps, the "
        f"ae_encoder's {sum('.ae_encoder.' in n for n in init)} tensors "
        f"unchanged, the rest moved")


def phase_ococc_fp32_step(dev):
    """One float32 training step (TF32 off, dropout 0, lr ``OCC_STEP_LR``)
    of one tracklet at full width, on the card and on the CPU from the same
    weights: the loss dict, every clipped gradient and every parameter after
    the update."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        train_cli.ococc_train_config(dtype="float32"), occ_dropout=0.0,
        attn_dropout=0.0, cls_dropout=0.0, reg_dropout=0.0,
        latent_dropout=0.0, fusion_dropout=0.0, base_lr=OCC_STEP_LR)
    batch = TrackletBatch(*(x[:1] for x in synthetic_batch(
        cfg, batch_size=bench.OCC_BATCH, seed=0)))
    res = []
    for where in (dev, torch.device("cpu")):
        model, optimizer, schedule = create_train_state(cfg, 100, where, 0)
        init = {n: p.detach().cpu().clone()
                for n, p in model.named_parameters()}
        metrics = make_train_step(model, optimizer, schedule)(0, batch)
        res.append(({k: float(v) for k, v in metrics.items()},
                    {n: (p.detach().cpu(), p.grad.cpu())
                     for n, p in model.named_parameters()}))
    lr = schedule(0)
    (card, card_p), (cpu, cpu_p) = res
    for k, ref in cpu.items():
        err = abs(card[k] - ref)
        tol = (OCC_STEP_GRAD_NORM_RTOL * ref if k == "grad_norm"
               else OCC_STEP_LOSS_ATOL)
        log(f"ococcnet fp32 step, card vs CPU: {k} {card[k]:.6f} vs "
            f"{ref:.6f}, err {err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"ococcnet fp32 step {k}: {err} > {tol}")
    grad_err = max((float((card_p[n][1] - g).abs().max()), n)
                   for n, (_, g) in cpu_p.items())
    log(f"ococcnet fp32 step, card vs CPU: {len(cpu_p)} clipped gradients, "
        f"worst {grad_err[1]} at {grad_err[0]:.3e} (tolerance "
        f"{OCC_STEP_GRAD_ATOL})")
    if not grad_err[0] <= OCC_STEP_GRAD_ATOL:
        raise AssertionError(f"ococcnet fp32 step gradients: {grad_err}")
    # the largest difference where the CPU's gradient lies within the
    # gradient bar of 0 (signs may differ), and where it does not
    near = far = moved = 0.0
    for n, (p, g) in cpu_p.items():
        diff = (card_p[n][0] - p).abs()
        small = g.abs() < OCC_STEP_GRAD_ATOL
        near = max(near, float(torch.where(small, diff, 0).max()))
        far = max(far, float(torch.where(small, 0, diff).max()))
        moved = max(moved, float((p - init[n]).abs().max()))
    near_tol = OCC_STEP_ROUNDING + 2 * lr
    far_tol = OCC_STEP_ROUNDING + 1e-3 * lr
    log(f"ococcnet fp32 step, card vs CPU: {len(cpu_p)} parameters after "
        f"the update at lr {lr:.3e} (largest move {moved:.3e}): {near:.3e} "
        f"where |g| < {OCC_STEP_GRAD_ATOL} (tolerance {near_tol:.3e}), "
        f"{far:.3e} elsewhere (tolerance {far_tol:.3e})")
    if not (near <= near_tol and far <= far_tol):
        raise AssertionError(f"ococcnet fp32 step parameters: {near}, {far}")
    if not moved > 0.5 * lr:
        raise AssertionError(f"ococcnet fp32 step: no parameter moved by "
                             f"half of lr {lr}: {moved}")


class EvalProbe:
    """While active, times the Evaluator's layers per length bucket (each
    call ends in a device synchronise) and records, for every occupancy IoU
    call, the per-frame inter and union and the count of decoded
    probabilities within ``EVAL_NEAR`` of the threshold."""

    def __init__(self):
        self.ms = collections.defaultdict(list)     # (layer, L) -> [ms]
        self.occ = []                               # (inter, union, near)

    def _timed(self, layer, fn, bucket):
        def call(*args, **kwargs):
            sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            self.ms[(layer, bucket(*args))].append(
                (time.perf_counter() - t) * 1e3)
            return out
        return call

    def __enter__(self):
        Ev, occ = evaluator.Evaluator, evaluator.occ_iou_mod
        self._saved = [(Ev, "_predict", Ev._predict),
                       (Ev, "_maybe_tune", Ev._maybe_tune),
                       (occ, "occ_iou_per_frame", occ.occ_iou_per_frame),
                       (occ, "occ_baseline_tracklet",
                        occ.occ_baseline_tracklet)]
        Ev._predict = self._timed("predict", Ev._predict,
                                  lambda ev, b: b.rois.shape[1])
        Ev._maybe_tune = self._timed(
            "tune", Ev._maybe_tune, lambda ev, pred, padded: (
                padded["rois"].shape[0] if ev.online_tuning_iters else None))
        occ_iou = occ.occ_iou_per_frame

        def recorded(decode_fn, latent, *args):
            near = []

            def decode(lat, q):
                logits = decode_fn(lat, q)
                near.append(((torch.sigmoid(logits) - args[-1]).abs()
                             < EVAL_NEAR).sum(-1))
                return logits

            inter, union = occ_iou(decode, latent, *args)
            self.occ.append((inter.cpu(), union.cpu(),
                             torch.cat(near).cpu()))
            return inter, union

        occ.occ_iou_per_frame = self._timed(
            "occ_iou", recorded, lambda dec, lat, *a: lat.shape[0])
        occ.occ_baseline_tracklet = self._timed(
            "baseline", occ.occ_baseline_tracklet,
            lambda points, *a: points.shape[0])
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def median(self, layer, L):
        times = self.ms.get((layer, L))
        return statistics.median(times) if times else float("nan")


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def tracklet_flags(paths):
    return ["--proposals", paths["proposals_file"], "--gt-candidates",
            paths["gt_candidates_file"], "--poses", paths["pose_file"],
            "--occ-root", paths["occ_anno_root"]]


def check_results_bin(what, path, frames):
    """One Waymo object per (tracklet, frame), ``frames`` in all."""
    recs = read_bin(path)
    keys = {(r["id"], r["timestamp"]) for r in recs}
    if len(recs) != frames or len(keys) != frames:
        raise AssertionError(f"{what}: {len(recs)} objects ({len(keys)} "
                             f"distinct) in {path}, expected {frames}")


def eval_cli_run(dev, argv, what):
    """``tools/test.py``'s ``main`` on ``argv`` (its JSON kept off the log)
    under an ``EvalProbe``; no hand-written kernel may launch. Returns the
    metrics, the probe, the wall seconds and the peak GiB."""
    torch.cuda.reset_peak_memory_stats(dev)
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    t = time.perf_counter()
    with EvalProbe() as probe, contextlib.redirect_stdout(io.StringIO()):
        metrics = test_cli.main(argv)
    wall = time.perf_counter() - t
    launched = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
    if any(launched):
        raise AssertionError(f"{what}: hand-written kernels launched "
                             f"{launched}; the path has none")
    if "OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/mAP" not in metrics:
        raise AssertionError(f"{what}: no mAP lines from the native binary: "
                             f"{sorted(metrics)}")
    return metrics, probe, wall, torch.cuda.max_memory_allocated(dev) / 2**30


def phase_ococc_eval(dev, train_dir):
    """``tools/test.py ococcnet`` at full width (``OcOccNetConfig()``, the
    dense eval layout, float32) on the OcOccNet training phase's checkpoint:
    its 8 tracklets of 40 frames (bucket 64) and 2 new ones of 200 frames
    (bucket 256), plain with ``--occ-baseline``, with ``--tta`` and with
    ``--tune-steps 10``; then ``ctrl`` on a checkpoint of 2 ``ctrl`` CLI
    steps, and ``tools/create_submission.py`` on a results ``.bin``."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()
    data = {"bucket64": (os.path.join(train_dir, "data"),
                         OCC_TRAIN_TRACKLETS, 40)}
    long_root = os.path.join(train_dir, "long")
    write_synthetic_dataset(long_root, num_tracklets=EVAL_LONG_TRACKLETS,
                            track_len=EVAL_LONG_FRAMES, seed=1)
    data["bucket256"] = (long_root, EVAL_LONG_TRACKLETS, EVAL_LONG_FRAMES)
    ckpt = os.path.join(train_dir, "work", "ckpt")
    for variant, extra in (("plain", ["--occ-baseline"]), ("tta", ["--tta"]),
                           ("tune", ["--tune-steps", str(EVAL_TUNE_STEPS)])):
        for bucket, (root, n, T) in data.items():
            paths = dataset_paths(root)
            out = os.path.join(train_dir, "eval", f"{variant}_{bucket}")
            what = f"tools/test.py ococcnet {variant} {bucket}"
            metrics, probe, wall, peak = eval_cli_run(
                dev, ["ococcnet", *tracklet_flags(paths), "--ckpt-dir", ckpt,
                      "--out-dir", out, "--device", "cuda", *extra], what)
            check_results_bin(what, metrics["results_bin"], n * T)
            occ = {k: v for k, v in metrics.items() if k.startswith("occ")}
            if "occ/overall_iou" not in occ or not all(
                    0.0 <= v <= 1.0 for v in occ.values()):
                raise AssertionError(f"{what}: occupancy metrics {occ}")
            if (variant == "plain") != ("occ_baseline/overall_iou" in occ):
                raise AssertionError(f"{what}: baseline metrics {occ}")
            L = int(bucket[6:])
            layers = {k: probe.median(k, L) for k in (
                "predict", "occ_iou", "tune", "baseline")
                if probe.ms.get((k, L))}
            log(f"{what}: {n} tracklets x {T} frames, wall {wall:.3f} s "
                f"({n / wall:.3f} tracklets/s through the CLI), per "
                f"tracklet ms (median) " + ", ".join(
                    f"{k} {v:.3f}" for k, v in layers.items())
                + f", peak memory {peak:.3f} GiB; occupancy " + ", ".join(
                    f"{k} {v:.4f}" for k, v in sorted(occ.items()))
                + f"; vehicle L1 mAP "
                f"{metrics['OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/mAP']:.4f}; "
                f"card {card}")
            if variant == "plain" and bucket == "bucket64":
                sub_bin = metrics["results_bin"]

    # CTRL: 2 CLI training steps at full width, then its evaluation
    paths = dataset_paths(data["bucket64"][0])
    work = os.path.join(train_dir, "ctrl")
    train_cli.main(["ctrl", *tracklet_flags(paths), "--total-steps",
                    str(CTRL_TRAIN_STEPS), "--work-dir", work, "--device",
                    "cuda", "--seed", "0"])
    what = "tools/test.py ctrl"
    metrics, probe, wall, peak = eval_cli_run(
        dev, ["ctrl", *tracklet_flags(paths), "--ckpt-dir",
              os.path.join(work, "ckpt"), "--out-dir",
              os.path.join(train_dir, "eval", "ctrl"), "--device", "cuda"],
        what)
    check_results_bin(what, metrics["results_bin"],
                      OCC_TRAIN_TRACKLETS * 40)
    if any(k.startswith("occ") for k in metrics):
        raise AssertionError(f"{what}: occupancy metrics without a decoder")
    log(f"{what}: {OCC_TRAIN_TRACKLETS} tracklets x 40 frames, wall "
        f"{wall:.3f} s, predict {probe.median('predict', 64):.3f} ms per "
        f"tracklet, peak {peak:.3f} GiB, vehicle L1 mAP "
        f"{metrics['OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/mAP']:.4f}")

    sub = os.path.join(train_dir, "submission")
    with contextlib.redirect_stdout(io.StringIO()):
        shards = submission_cli.main([sub_bin, "--out-dir", sub,
                                      "--method-name", "chip_smoke"])
    payload = b"".join(read_submission(p)["objects_payload"]
                       for p in shards[:-1])
    if payload != open(sub_bin, "rb").read() or not os.path.exists(
            shards[-1]):
        raise AssertionError(f"create_submission: {shards}")
    log(f"tools/create_submission.py: {len(shards) - 1} shards and "
        f"{os.path.basename(shards[-1])} hold the {len(read_bin(sub_bin))} "
        f"objects of {os.path.relpath(sub_bin, train_dir)}")


def dataset_paths(root):
    return dict(proposals_file=os.path.join(root, "proposals.pkl"),
                gt_candidates_file=os.path.join(root, "gt_candidates.pkl"),
                pose_file=os.path.join(root, "poses.pkl"),
                occ_anno_root=os.path.join(root, "occ_gt"))


def phase_eval_fp32_check(dev):
    """One float32 ``Evaluator.run`` of one 40-frame tracklet at full width
    (TF32 off), on the card and on the CPU from the same weights: plain,
    with TTA and with ``EVAL_CHECK_TUNE_STEPS`` tuning steps. Boxes and
    scores of every frame, and each frame's occupancy inter and union up
    to the probabilities near the threshold, each at its stated bar."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(train_cli.ococc_train_config(),
                              packed_point_budget=None)
    weights = OcOccNetWithLoss(cfg, "cpu",
                               torch.Generator().manual_seed(0)).state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_synthetic_dataset(os.path.join(tmp, "data"),
                                        num_tracklets=1, track_len=40, seed=2)
        ds = TrackletDataset(cfg=cfg, training=False, min_tracklet_length=1,
                             **paths)
        for name, opts in (("plain", {}), ("tta", {"tta": True}),
                           ("tune", {"online_tuning_iters":
                                     EVAL_CHECK_TUNE_STEPS})):
            res = []
            for where in (dev, torch.device("cpu")):
                model = OcOccNetWithLoss(cfg, where)
                model.load_state_dict(weights)
                t = time.perf_counter()
                with EvalProbe() as probe:
                    m = evaluator.Evaluator(model, ds, cfg, device=where,
                                            **opts).run(
                        os.path.join(tmp, f"{name}_{where.type}"),
                        eval_waymo=False)
                res.append((m, read_bin(m["results_bin"]), probe.occ,
                            time.perf_counter() - t))
            (m_card, card, occ_card, t_card), (m_cpu, cpu, occ_cpu, t_cpu) = \
                res
            box_err = max(abs(a["box"][k] - b["box"][k])
                          for a, b in zip(card, cpu) for k in range(1, 8))
            score_err = max(abs(a["score"] - b["score"])
                            for a, b in zip(card, cpu))
            (ic, uc, nc), (ir, ur, nr) = occ_card[0], occ_cpu[0]
            near = nc + nr
            count_err = torch.maximum((ic - ir).abs(), (uc - ur).abs())
            log(f"eval fp32 {name}, card vs CPU (1 tracklet x 40 frames): "
                f"boxes max abs err {box_err:.3e} m (tolerance "
                f"{EVAL_BOX_ATOL}), scores {score_err:.3e} (tolerance "
                f"{EVAL_SCORE_ATOL}), inter / union counts differ by at "
                f"most {int(count_err.max())} with {int(near.sum())} "
                f"probabilities within {EVAL_NEAR} of the threshold (bar: "
                f"each frame's near count); occ/overall_iou "
                f"{m_card['occ/overall_iou']:.6f} vs "
                f"{m_cpu['occ/overall_iou']:.6f}; {t_card:.1f} s on the "
                f"card, {t_cpu:.1f} s on the CPU")
            if not (len(card) == len(cpu) == 40 and box_err <= EVAL_BOX_ATOL
                    and score_err <= EVAL_SCORE_ATOL
                    and bool((count_err <= near).all())):
                raise AssertionError(f"eval fp32 {name}: card vs CPU beyond "
                                     f"the bars")


def phase_sst_eval(dev, train_dir):
    """``tools/test.py sst --metric kitti`` and ``--metric waymo`` on the
    float32 SST training phase's checkpoint and frames, its classification
    bias lifted by ``SST_EVAL_CLS_LIFT`` so that the decode keeps boxes of
    the barely trained model. Counts the attention kernels' launches (12
    forward per level per frame, no backward) and times the predict per
    frame. Returns the forward launches."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    ckpt = CheckpointManager(os.path.join(train_dir, "work", "ckpt"))
    state = torch.load(ckpt.path(ckpt.steps()[-1]), map_location="cpu",
                       weights_only=True)
    state["model"]["head.cls.bias"] += SST_EVAL_CLS_LIFT
    lifted = os.path.join(train_dir, "ckpt_eval")
    os.makedirs(lifted, exist_ok=True)
    torch.save(state, os.path.join(lifted, "step_1.pt"))
    frames = os.path.join(train_dir, "frames")
    n = len(FrameDataset(os.path.join(frames, "infos.pkl"), frames))
    per_level = 2 * bench.sst_config().sst.num_blocks
    make = detector_eval.make_predict_fn
    total = collections.Counter()
    try:
        for metric in ("kitti", "waymo"):
            times = []

            def timed_make(model, family):
                fn = make(model, family)

                def call(points, mask):
                    sync()
                    t = time.perf_counter()
                    out = fn(points, mask)
                    sync()
                    times.append((time.perf_counter() - t) * 1e3)
                    return out
                return call

            detector_eval.make_predict_fn = timed_make
            wa.LAUNCHES.clear()
            wa.BWD_LAUNCHES.clear()
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                metrics = test_cli.main([
                    "sst", "--infos", os.path.join(frames, "infos.pkl"),
                    "--data-root", frames, "--ckpt-dir", lifted, "--metric",
                    metric, "--out-dir", os.path.join(train_dir, metric),
                    "--device", "cuda"])
            wall = time.perf_counter() - t
            fwd, bwd = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
            expect = {32: per_level * n, 144: per_level * n}
            if fwd != expect or bwd:
                raise AssertionError(f"sst eval {metric}: launches forward "
                                     f"{fwd} backward {bwd}, expected "
                                     f"{expect} and none")
            total.update(fwd)
            if metric == "kitti":
                shown = {k: v for k, v in metrics.items() if "_3d_" in k}
                if len(shown) != 3:
                    raise AssertionError(f"sst kitti metrics {metrics}")
            else:
                shown = {k: v for k, v in metrics.items()
                         if k.startswith("OBJECT_TYPE_TYPE_VEHICLE")}
                preds = read_bin(os.path.join(train_dir, metric, "pred.bin"))
                if not shown or not preds:
                    raise AssertionError(f"sst waymo: {len(preds)} "
                                         f"predictions, metrics {metrics}")
            log(f"tools/test.py sst --metric {metric}: {n} frames, wall "
                f"{wall:.3f} s, predict {statistics.median(times):.3f} "
                f"ms/frame (median; {[round(x, 3) for x in times]}), "
                f"launches forward {fwd} backward 0; {shown}; card "
                f"{card_info()}")
    finally:
        detector_eval.make_predict_fn = make
    return dict(total)


def no_kernel_launches(what):
    """The window-attention kernels' counts since they were last cleared:
    CenterPoint's and the FSD family's paths launch none."""
    launched = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
    if any(launched):
        raise AssertionError(f"{what}: window-attention kernels launched "
                             f"{launched}; this path has none")


def voxel_line(rows):
    return ", ".join(f"{r['stage']} {r['occupied']}/{r['budget']}"
                     for r in rows)


def phase_centerpoint(dev):
    """Full-width CenterPoint inference (float32) on the dense and the
    sparse synthetic frame: the predict's ms per frame, the peak memory,
    the voxels per stage; 0 window-attention launches."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    model = bench.build_centerpoint(device=dev, seed=0)
    predict = make_predict_fn(model, "centerpoint")
    frames = {"dense": bench.frame_tensors(model.cfg, dev, 150000, seed=0),
              "sparse": bench.frame_tensors(model.cfg, dev, 20000, seed=1)}
    for name, (pts, msk) in frames.items():
        log(f"centerpoint frame {name}: voxels per stage (occupied/budget) "
            f"{voxel_line(model.voxel_occupancy(pts, msk))}")
        predict(pts, msk)                          # warm-up
    torch.cuda.synchronize()
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    for name, (pts, msk) in frames.items():
        out = predict(pts, msk)
        shapes = [tuple(x.shape) for x in out]
        if shapes != [(500, 9), (500,), (500,), (500,)] or not all(
                torch.isfinite(x.float()).all() for x in out):
            raise AssertionError(f"centerpoint predict: shapes {shapes} or "
                                 f"values not finite")
        times = bench.time_frames(predict, pts, msk, CP_TIMED_FRAMES,
                                  warmup=0)
        log(f"centerpoint frame {name}: float32 predict "
            f"{statistics.median(times):.3f} ms/frame (median of "
            f"{CP_TIMED_FRAMES}: {[round(t, 3) for t in times]}), "
            f"{int(out[3].sum())} boxes over the score threshold")
    no_kernel_launches("centerpoint inference")
    log(f"centerpoint inference: peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB, "
        f"window-attention launches 0; card {card_info()}")


def compare_outputs(what, got, ref, keys, rtol=CP_CPU_RTOL):
    """Each output of ``keys`` finite and within ``rtol`` of the larger of 1
    and its magnitude."""
    for key in keys:
        g, r = got[key].detach().float().cpu(), ref[key].detach().float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: {key} not finite")
        mag = r.abs().max().item()
        err = (g - r).abs().max().item()
        tol = rtol * max(1.0, mag)
        log(f"{what}: {key} max abs err {err:.3e} (tolerance {tol:.3e}; "
            f"magnitude {mag:.3f})")
        if not err <= tol:
            raise AssertionError(f"{what} {key}: {err} > {tol}")


def phase_cp_card_vs_cpu(dev):
    """One dense frame's head maps, full width, float32: the card with TF32
    off and under the CLI's settings (cuDNN convolutions in TF32) against
    the port on the CPU, same weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.build_centerpoint(device=dev, seed=0)
    cpu = bench.build_centerpoint(device="cpu", seed=0)
    pts, msk = bench.frame_tensors(card.cfg, dev, 150000, seed=0)
    wa.LAUNCHES.clear()
    with torch.inference_mode():
        ref = cpu(pts.cpu(), msk.cpu())
        a = card(pts, msk)
        compare_outputs("centerpoint fp32, card vs CPU", a, ref, CP_HEADS)
        torch.backends.cudnn.allow_tf32 = True
        b = card(pts, msk)
        compare_outputs("centerpoint fp32 under the CLI's TF32 settings "
                        "(cuDNN TF32 on, matmul TF32 off), card vs CPU", b,
                        ref, CP_HEADS, CP_TF32_CPU_RTOL)
    torch.backends.cudnn.allow_tf32 = False
    no_kernel_launches("centerpoint card vs CPU")


def phase_cp_training(dev, frames_dir, work):
    """Full-width CenterPoint training through ``tools/train.py
    centerpoint``'s ``main`` on the SST training phase's 3 synthetic
    frames, under the CLI's own TF32 settings; ms/step from the third."""
    infos = os.path.join(frames_dir, "infos.pkl")
    stamps = []

    def hook(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats(dev)
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    t0 = time.perf_counter()
    done = train_cli.main(["centerpoint", "--infos", infos, "--data-root",
                           frames_dir, "--total-steps", str(CP_TRAIN_STEPS),
                           "--log-interval", "1", "--work-dir", work,
                           "--device", "cuda", "--seed", "0"], hooks=[hook])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    no_kernel_launches("centerpoint training")
    if done != CP_TRAIN_STEPS or len(stamps) != CP_TRAIN_STEPS:
        raise AssertionError(f"centerpoint training ran {len(stamps)} steps")
    rows = [json.loads(line) for line in
            open(os.path.join(work, "metrics.jsonl"))]
    keys = ("loss", "loss_heatmap", "loss_bbox", "grad_norm")
    if [r["step"] for r in rows] != list(range(1, CP_TRAIN_STEPS + 1)) or \
            not all(abs(r[k]) < float("inf") for r in rows for k in keys):
        raise AssertionError(f"centerpoint training metrics {rows}")
    for r in rows:
        log("centerpoint training step " + " ".join(
            f"{k}={r[k]}" for k in ("step",) + keys + ("frames_per_sec",)))
    trained = torch.load(os.path.join(work, "ckpt",
                                      f"step_{CP_TRAIN_STEPS}.pt"),
                         map_location="cpu", weights_only=True)["model"]
    init = train_cli.build_detector(
        "centerpoint", device="cpu",
        generator=torch.Generator().manual_seed(0)).state_dict()
    same = {n for n, p in init.items() if torch.equal(p, trained[n])}
    # the velocity branch's code weights are 0: no gradient, no decay
    if same != {"head.task0.GroupNorm_6.weight",
                "head.task0.GroupNorm_6.bias", "head.task0.vel_out.bias"}:
        raise AssertionError(f"centerpoint parameters that did not move: "
                             f"{sorted(same)}")
    times = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    timed = times[TRAIN_TIMED_FROM - 1:]
    log(f"centerpoint training: {CP_TRAIN_STEPS} float32 steps at full "
        f"width through the CLI, {statistics.median(timed):.3f} ms/step "
        f"(median of steps {TRAIN_TIMED_FROM}-{CP_TRAIN_STEPS}; all "
        f"{[round(x, 3) for x in times]}), peak memory {peak:.3f} GiB, "
        f"window-attention launches 0, {len(init) - len(same)} of "
        f"{len(init)} parameter tensors moved; card {card_info()}")
    return statistics.median(timed), peak


def phase_cp_fp32_step(dev, layout="gather"):
    """One float32 training step (TF32 off, lr ``CP_STEP_LR``) of one dense
    frame at full width on the card and on the CPU from the same weights,
    the encoder in ``layout`` (float32 activations): the loss dict, every
    clipped gradient and every parameter after the update. In both layouts
    the card's ReLU routes are fed to the CPU (``ops/routes.py``; unfed,
    ReLU inputs within a rounding step of 0 sent 77 gradients of the column
    step up to 12 times over their bars, PERF.md section 6), at most
    ``CP_ROUTE_FLIPS`` of the fed elements differing from the CPU's own.
    Each route is recorded once: the gather layout recomputes nothing, and
    the column layout's residual blocks are not recomputed here (the
    training phase runs remat, the CPU tests hold it to the JAX
    package)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = []
    for card, where in ((True, dev), (False, torch.device("cpu"))):
        model = bench.build_centerpoint(device=where, seed=0, layout=layout,
                                        dtype="float32").train()
        model.encoder.remat_blocks = False
        batch = bench.train_batch(model.cfg, where, 150000, seed=0)
        init = {n: p.detach().cpu().clone()
                for n, p in model.named_parameters()}
        optimizer, schedule = make_optimizer(model.named_parameters(),
                                             CP_STEP_LR, 100)
        step_fn = make_detector_train_step(model, optimizer, schedule)
        if card:
            with Routes() as routes:
                metrics = step_fn(0, batch)
        else:
            with Routes([m.cpu() for m in routes.masks]) as fed:
                metrics = step_fn(0, batch)
        res.append(({k: float(v) for k, v in metrics.items()},
                    {n: (p.detach().cpu(), p.grad.cpu())
                     for n, p in model.named_parameters()}))
        del model, optimizer, step_fn
    no_kernel_launches(f"centerpoint fp32 step ({layout})")
    log(f"centerpoint fp32 step ({layout} layout): the card's "
        f"{len(routes.masks)} ReLU routes' {fed.fed} elements fed to the "
        f"CPU, {fed.flips} differ from the CPU's own (bar "
        f"{CP_ROUTE_FLIPS:.0e} of those fed; (call, op, shape, count): "
        f"{fed.flipped})")
    if not fed.flips <= CP_ROUTE_FLIPS * fed.fed:
        raise AssertionError(f"centerpoint fp32 step ({layout}): "
                             f"{fed.flips} of {fed.fed} route elements "
                             f"differ")
    check_step_card_vs_cpu(f"centerpoint fp32 step ({layout} layout)", res,
                           init, schedule(0))


def phase_cp_eval(dev, frames_dir, work):
    """``tools/test.py centerpoint --metric kitti`` and ``--metric waymo``
    on the CenterPoint training phase's checkpoint (its heatmap bias lifted
    by ``CP_EVAL_HM_LIFT`` so that the decode keeps boxes) and frames:
    the predict's ms per frame under the CLI; 0 window-attention
    launches."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    ckpt = CheckpointManager(os.path.join(work, "ckpt"))
    state = torch.load(ckpt.path(ckpt.steps()[-1]), map_location="cpu",
                       weights_only=True)
    state["model"]["head.task0.heatmap_out.bias"] += CP_EVAL_HM_LIFT
    lifted = os.path.join(work, "ckpt_eval")
    os.makedirs(lifted, exist_ok=True)
    torch.save(state, os.path.join(lifted, "step_1.pt"))
    infos = os.path.join(frames_dir, "infos.pkl")
    n = len(FrameDataset(infos, frames_dir))
    make = detector_eval.make_predict_fn
    try:
        for metric in ("kitti", "waymo"):
            times = []

            def timed_make(model, family):
                fn = make(model, family)

                def call(points, mask):
                    sync()
                    t = time.perf_counter()
                    out = fn(points, mask)
                    sync()
                    times.append((time.perf_counter() - t) * 1e3)
                    return out
                return call

            detector_eval.make_predict_fn = timed_make
            wa.LAUNCHES.clear()
            wa.BWD_LAUNCHES.clear()
            t = time.perf_counter()
            out_dir = os.path.join(work, metric)
            with contextlib.redirect_stdout(io.StringIO()):
                metrics = test_cli.main([
                    "centerpoint", "--infos", infos, "--data-root",
                    frames_dir, "--ckpt-dir", lifted, "--metric", metric,
                    "--out-dir", out_dir, "--device", "cuda"])
            wall = time.perf_counter() - t
            no_kernel_launches(f"centerpoint eval {metric}")
            if len(times) != n:
                raise AssertionError(f"centerpoint eval {metric}: "
                                     f"{len(times)} predicts for {n} frames")
            if metric == "kitti":
                shown = {k: v for k, v in metrics.items() if "_3d_" in k}
                if len(shown) != 3:
                    raise AssertionError(f"centerpoint kitti {metrics}")
            else:
                shown = {k: v for k, v in metrics.items()
                         if k.startswith("OBJECT_TYPE_TYPE_VEHICLE")}
                preds = read_bin(os.path.join(out_dir, "pred.bin"))
                if not shown or not preds:
                    raise AssertionError(f"centerpoint waymo: {len(preds)} "
                                         f"predictions, metrics {metrics}")
            log(f"tools/test.py centerpoint --metric {metric}: {n} frames, "
                f"wall {wall:.3f} s, predict "
                f"{statistics.median(times):.3f} ms/frame (median; "
                f"{[round(x, 3) for x in times]}), window-attention "
                f"launches 0; {shown}; card {card_info()}")
    finally:
        detector_eval.make_predict_fn = make


def fsd_model(family, dtype, clustering, device):
    """A full-width FSD-family model of the training CLI with seeded random
    weights; ``clustering`` False: FSDv2."""
    if clustering:
        return bench.build_frame_detector(family, dtype, device, seed=0)
    cfg = dataclasses.replace(train_cli.fsd_train_config(dtype=dtype),
                              use_clustering=False)
    return FSD(cfg, device=device,
               generator=torch.Generator().manual_seed(0)).eval()


def budget_line(rows):
    """The FSD budgets' counts as ``occupied/budget``."""
    unet = ", ".join(f"level {r['level']} {r['occupied']}/{r['budget']}"
                     for r in rows.pop("unet"))
    rest = "; ".join(
        f"{k}: " + (", ".join(f"{n} {a}/{b}" for n, (a, b) in v.items())
                    if isinstance(v, dict) else f"{v[0]}/{v[1]}")
        for k, v in rows.items())
    return f"UNet voxels {unet}; {rest}"


def phase_fsd(dev):
    """Full-width FSD (float32 and bf16), FSDv2 and two-stage FSD inference
    on the dense and the sparse synthetic frame: predict shapes, finite
    where valid, the median ms per frame, the peak memory, the budgets'
    counts; 0 window-attention launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    for name, family, dtype, clustering in FSD_VARIANTS:
        model = fsd_model(family, dtype, clustering, dev)
        predict = make_predict_fn(model, family)
        n_slots = model.cfg.fsd.max_clusters if family == "fsd2" \
            else model.cfg.max_clusters
        frames = {"dense": bench.frame_tensors(model.cfg, dev, 150000, 0),
                  "sparse": bench.frame_tensors(model.cfg, dev, 20000, 1)}
        for pts, msk in frames.values():
            predict(pts, msk)                     # warm-up
        torch.cuda.synchronize()
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        for frame, (pts, msk) in frames.items():
            boxes, scores, labels, valid = predict(pts, msk)
            shapes = [tuple(x.shape) for x in (boxes, scores, labels,
                                               valid)]
            if shapes != [(n_slots, 7), (n_slots,), (n_slots,),
                          (n_slots,)] or not (
                    torch.isfinite(boxes[valid]).all()
                    and torch.isfinite(scores).all()):
                raise AssertionError(f"{name} predict: shapes {shapes} or "
                                     f"values not finite")
            times = bench.time_frames(predict, pts, msk, FSD_TIMED_FRAMES,
                                      warmup=0)
            log(f"{name} frame {frame}: predict "
                f"{statistics.median(times):.3f} ms/frame (median of "
                f"{FSD_TIMED_FRAMES}: {[round(t, 3) for t in times]}), "
                f"{int(valid.sum())} valid of {n_slots} slots, "
                f"{int((valid & (scores > 0.1)).sum())} over 0.1")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        no_kernel_launches(f"{name} inference")
        for frame, (pts, msk) in frames.items():
            log(f"{name} frame {frame}: budgets (occupied/budget) "
                f"{budget_line(bench.budgets(model, pts, msk)['budgets'])}")
        log(f"{name} inference: peak memory {peak:.3f} GiB, "
            f"window-attention launches 0; card {card_info()}")


def compare_fsd(what, got, ref, keys, rtol=FSD_CPU_RTOL):
    for key in keys:
        g = got[key].float().cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: {key} not finite")
        mag = ref[key].abs().max().item()
        err = (g - ref[key].float()).abs().max().item()
        tol = rtol * max(1.0, mag)
        log(f"{what}: {key} max abs err {err:.3e} (tolerance {tol:.3e}; "
            f"magnitude {mag:.3f})")
        if not err <= tol:
            raise AssertionError(f"{what} {key}: {err} > {tol}")


def cluster_slots(grouping, n):
    """The cluster slots that hold a point under ``grouping``."""
    lab = grouping.fg_label.reshape(-1)
    return torch.bincount(lab[lab >= 0], minlength=n)[:n] > 0


def card_selection(model, points, mask):
    """The card model's grouping and pooled points on a frame."""
    seg_logits, votes, pv, _ = model.stage1.segment(points, mask)
    grouping = model.stage1.group(points, seg_logits, votes, pv)
    out1 = model.stage1(points, mask, grouping)
    return grouping, model.select_points(points, mask, out1["boxes"])


def to_cpu(grouping, selection):
    return (Grouping(*(t.cpu() for t in grouping)),
            tuple(t.cpu() for t in selection))


def phase_fsd_card_vs_cpu(dev):
    """One dense frame, full width, float32, TF32 off, same weights: the
    segmentation at ``FSD_CPU_RTOL``; the grouping (slots that differ,
    printed); the cluster forward and the two-stage outputs, both devices
    fed the card's grouping and pooled points, at ``FSD_CPU_RTOL``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.build_frame_detector("fsd2", None, dev, seed=0)
    cpu = bench.build_frame_detector("fsd2", None, "cpu", seed=0)
    pts, msk = bench.frame_tensors(card.cfg, dev, 150000, seed=0)
    n = card.cfg.fsd.max_clusters
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    with torch.inference_mode():
        seg_c = card.stage1.segment(pts, msk)
        seg_p = cpu.stage1.segment(pts.cpu(), msk.cpu())
        compare_fsd("fsd segmentation fp32, card vs CPU",
                    dict(seg_logits=seg_c[0], votes=seg_c[1]),
                    dict(seg_logits=seg_p[0], votes=seg_p[1]),
                    ("seg_logits", "votes"))
        if not torch.equal(seg_c[2].cpu(), seg_p[2]):
            raise AssertionError("fsd point validity differs")
        g_card = card.stage1.group(pts, *seg_c[:3])
        g_cpu = cpu.stage1.group(pts.cpu(), *seg_p[:3])
        diff = {k: int((a.cpu() != b).sum()) for k, a, b in zip(
            g_card._fields, g_card[:2], g_cpu[:2])}
        diff["cluster_valid"] = int((cluster_slots(g_card, n).cpu()
                                     != cluster_slots(g_cpu, n)).sum())
        log(f"fsd grouping fp32, card vs CPU, each on its own segmentation: "
            f"slots that differ {diff} (of {g_card.fg_idx.numel()} "
            f"foreground slots and {n} clusters; "
            f"{int(cluster_slots(g_card, n).sum())} clusters on the card)")

        grouping, selection = card_selection(card, pts, msk)
        g_p, sel_p = to_cpu(grouping, selection)
        out_c = card(pts, msk, grouping, selection)
        out_p = cpu(pts.cpu(), msk.cpu(), g_p, sel_p)
        if not torch.equal(out_c["cluster_valid"].cpu(),
                           out_p["cluster_valid"]):
            raise AssertionError("fsd cluster validity differs")
        compare_fsd("fsd cluster forward fp32 from the card's grouping, "
                    "card vs CPU", out_c, out_p, FSD_CLUSTER_KEYS)
        compare_fsd("fsd cluster forward fp32 from the card's grouping, "
                    "card vs CPU", out_c, out_p, FSD_BOX_KEYS, FSD_BOX_RTOL)
        own = cpu.select_points(pts.cpu(), msk.cpu(), out_p["boxes"])
        moved = int((own[1] != sel_p[1]).any(-1).sum())
        if not torch.equal(out_c["roi_nonempty"].cpu(),
                           out_p["roi_nonempty"]):
            raise AssertionError("fsd2 non-empty RoIs differ")
        compare_fsd("fsd2 stage 2 fp32 from the card's grouping and pooled "
                    "points, card vs CPU", out_c, out_p, FSD2_KEYS)
        compare_fsd("fsd2 stage 2 fp32 from the card's grouping and pooled "
                    "points, card vs CPU", out_c, out_p, ("refined_boxes",),
                    FSD_BOX_RTOL)
        log(f"fsd2: {int(out_c['roi_nonempty'].sum())} non-empty RoIs; "
            f"the CPU's own pooling from its own proposals differs from "
            f"the card's in {moved} RoIs")
    no_kernel_launches("fsd card vs CPU")


def phase_fsd_training(dev, frames_dir, work):
    """``tools/train.py fsd`` and ``fsd2``'s ``main`` at full width on the
    SST training phase's 3 frames: 4 float32 steps each, finite losses,
    every parameter moved but regression branches without positives
    (``FSD_REGRESSION``), ms/step from the third, peak memory."""
    infos = os.path.join(frames_dir, "infos.pkl")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    for family in ("fsd", "fsd2"):
        stamps = []

        def hook(step, metrics):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        out = os.path.join(work, family)
        torch.cuda.reset_peak_memory_stats(dev)
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        t0 = time.perf_counter()
        done = train_cli.main([
            family, "--infos", infos, "--data-root", frames_dir,
            "--total-steps", str(FSD_TRAIN_STEPS), "--log-interval", "1",
            "--work-dir", out, "--device", "cuda", "--seed", "0"],
            hooks=[hook])
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        no_kernel_launches(f"{family} training")
        if done != FSD_TRAIN_STEPS or len(stamps) != FSD_TRAIN_STEPS:
            raise AssertionError(f"{family} training ran {len(stamps)} "
                                 f"steps")
        rows = [json.loads(line) for line in
                open(os.path.join(out, "metrics.jsonl"))]
        keys = ("loss", "loss_seg", "loss_vote", "loss_cls", "grad_norm") + (
            ("loss_cls2", "loss_reg2", "loss_corner2") if family == "fsd2"
            else ())
        if [r["step"] for r in rows] != list(
                range(1, FSD_TRAIN_STEPS + 1)) or not all(
                abs(r[k]) < float("inf") for r in rows for k in keys):
            raise AssertionError(f"{family} training metrics {rows}")
        for r in rows:
            log(f"{family} training step " + " ".join(
                f"{k}={r[k]}" for k in ("step",) + keys
                + ("num_pos_clusters", "frames_per_sec") if k in r))
        trained = torch.load(os.path.join(out, "ckpt",
                                          f"step_{FSD_TRAIN_STEPS}.pt"),
                             map_location="cpu", weights_only=True)["model"]
        init = train_cli.build_detector(
            family, device="cpu",
            generator=torch.Generator().manual_seed(0)).state_dict()
        same = sorted(n for n, p in init.items()
                      if torch.equal(p, trained[n]))
        if not all(any(r in n for r in FSD_REGRESSION)
                   and (n.endswith("bias") or "LayerNorm" in n)
                   for n in same):
            raise AssertionError(f"{family} parameters that did not move: "
                                 f"{same}")
        times = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
        timed = times[TRAIN_TIMED_FROM - 1:]
        log(f"{family} training: {FSD_TRAIN_STEPS} float32 steps at full "
            f"width through the CLI, {statistics.median(timed):.3f} ms/step "
            f"(median of steps {TRAIN_TIMED_FROM}-{FSD_TRAIN_STEPS}; all "
            f"{[round(x, 3) for x in times]}), peak memory {peak:.3f} GiB, "
            f"window-attention launches 0, {len(init) - len(same)} of "
            f"{len(init)} parameter tensors moved (unmoved, regression "
            f"branches without positives: {same}); card {card_info()}")


def phase_fsd2_fp32_step(dev):
    """One float32 ``fsd2`` training step (TF32 off, lr ``CP_STEP_LR``) of
    one dense frame at full width on the card and on the CPU from the same
    weights, both fed the card's grouping and pooled points: the loss dict,
    every clipped gradient and every parameter after the update, at
    CenterPoint's bars."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.build_frame_detector("fsd2", None, dev, seed=0)
    batch = bench.train_batch(card.cfg, dev, 150000, seed=0)
    with torch.no_grad():
        fixed = card_selection(card, batch.points[0], batch.points_mask[0])
    res = []
    for where, (grouping, selection) in ((dev, fixed),
                                         ("cpu", to_cpu(*fixed))):
        model = bench.build_frame_detector("fsd2", None, where,
                                           seed=0).train()

        def loss(points, mask, *gt, model=model, grouping=grouping,
                 selection=selection):
            return two_stage_loss(model(points, mask, grouping, selection),
                                  points, *gt)

        model.loss = loss
        init = {n: p.detach().cpu().clone()
                for n, p in model.named_parameters()}
        optimizer, schedule = make_optimizer(model.named_parameters(),
                                             CP_STEP_LR, 100)
        metrics = make_detector_train_step(model, optimizer, schedule)(
            0, batch.to(where))
        res.append(({k: float(v) for k, v in metrics.items()},
                    {n: (p.detach().cpu(), p.grad.cpu())
                     for n, p in model.named_parameters()}))
    no_kernel_launches("fsd2 fp32 step")
    check_step_card_vs_cpu("fsd2 fp32 step", res, init, schedule(0))


def check_step_card_vs_cpu(what, res, init, lr):
    """The losses, the clipped gradients and the parameters after AdamW's
    first step of a card run against a CPU run, at ``CP_STEP_*``; every
    gradient and parameter finite on both devices."""
    (card, card_p), (cpu, cpu_p) = res
    for k, ref in cpu.items():
        err = abs(card[k] - ref)
        tol = CP_STEP_LOSS_RTOL * max(1.0, abs(ref))
        log(f"{what}, card vs CPU: {k} {card[k]:.6f} vs {ref:.6f}, err "
            f"{err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{what} {k}: {err} > {tol}")
    for where, params in (("card", card_p), ("CPU", cpu_p)):
        bad = [n for n, (p, g) in params.items()
               if not (torch.isfinite(p).all() and torch.isfinite(g).all())]
        if bad:
            raise AssertionError(f"{what}: parameters or gradients not "
                                 f"finite on the {where}: {bad}")
    largest = max(float(g.abs().max()) for _, g in cpu_p.values())
    bars = {n: CP_STEP_GRAD_RTOL * float(g.abs().max())
            + CP_STEP_GRAD_FLOOR * largest for n, (_, g) in cpu_p.items()}
    shares = {n: float((card_p[n][1] - g).abs().max()) / bars[n]
              for n, (_, g) in cpu_p.items()}
    # a NaN share (a 0 bar) counts as the worst and over its bar
    worst = max(shares, key=lambda n: shares[n] if shares[n] == shares[n]
                else float("inf"))
    over = sorted(n for n, x in shares.items() if not x <= 1.0)
    log(f"{what}, card vs CPU: {len(cpu_p)} clipped gradients (largest "
        f"|g| {largest:.3e}), worst share of its bar {shares[worst]:.3e} "
        f"at {worst}; over the bar: {[(n, shares[n]) for n in over]}")
    if over:
        raise AssertionError(f"{what} gradients over their bars: "
                             f"{[(n, shares[n]) for n in over]}")
    near = far = moved = 0.0
    for n, (p, g) in cpu_p.items():
        diff = (card_p[n][0] - p).abs()
        small = g.abs() < bars[n]
        near = max(near, float(torch.where(small, diff, 0).max()))
        far = max(far, float(torch.where(small, 0, diff).max()))
        moved = max(moved, float((p - init[n]).abs().max()))
    near_tol = CP_STEP_ROUNDING + 2 * lr
    far_tol = CP_STEP_ROUNDING + 1e-3 * lr
    log(f"{what}, card vs CPU: {len(cpu_p)} parameters after the update at "
        f"lr {lr:.3e} (largest move {moved:.3e}): {near:.3e} where |g| lies "
        f"within its bar (tolerance {near_tol:.3e}), {far:.3e} elsewhere "
        f"(tolerance {far_tol:.3e})")
    if not (near <= near_tol and far <= far_tol):
        raise AssertionError(f"{what} parameters: {near}, {far}")
    if not moved > 0.5 * lr:
        raise AssertionError(f"{what}: no parameter moved by half of lr "
                             f"{lr}: {moved}")


def lift_fsd_checkpoint(work, family):
    """The training checkpoint of ``family`` (``fsd``, ``fsd2``,
    ``fsdpp``) with ``FSD_EVAL_LIFT`` added to the seg head's class-logit
    biases and the score biases; returns its directory."""
    ckpt = CheckpointManager(os.path.join(work, family, "ckpt"))
    state = torch.load(ckpt.path(ckpt.steps()[-1]), map_location="cpu",
                       weights_only=True)
    model = state["model"]
    # FSD++'s sequential evaluation scores stage 1's boxes
    pre = {"fsd": "", "fsd2": "stage1.", "fsdpp": "fsd.stage1."}[family]
    ncls = len(train_cli.fsd_train_config().class_names)
    seg = sorted(k for k in model if k.startswith(pre + "seg_head.Dense_")
                 and k.endswith(".bias"))[-1]
    model[seg][:ncls] += FSD_EVAL_LIFT
    scores = ([k for k in model if k.startswith("conv_cls.Dense_")
               and k.endswith(".bias")][-1:] if family == "fsd2" else
              [k for k in model if k.startswith(pre)
               and "_score.Dense_" in k and k.endswith(
                  f"Dense_{train_cli.fsd_train_config().head_layers}.bias")])
    for k in scores:
        model[k] += FSD_EVAL_LIFT
    lifted = os.path.join(work, family, "ckpt_eval")
    os.makedirs(lifted, exist_ok=True)
    torch.save(state, os.path.join(lifted, "step_1.pt"))
    return lifted, [seg] + scores


def phase_fsd_eval(dev, frames_dir, work):
    """``tools/test.py fsd`` and ``fsd2`` with ``--metric kitti`` and
    ``--metric waymo`` on the training phase's checkpoints (biases lifted
    by ``FSD_EVAL_LIFT``) and frames: the predict's ms per frame under the
    CLI; 0 window-attention launches."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    infos = os.path.join(frames_dir, "infos.pkl")
    n = len(FrameDataset(infos, frames_dir))
    make = detector_eval.make_predict_fn
    try:
        for family in ("fsd", "fsd2"):
            lifted, keys = lift_fsd_checkpoint(work, family)
            log(f"{family} evaluation: {FSD_EVAL_LIFT} added to {keys}")
            for metric in ("kitti", "waymo"):
                times = []

                def timed_make(model, fam):
                    fn = make(model, fam)

                    def call(points, mask):
                        sync()
                        t = time.perf_counter()
                        out = fn(points, mask)
                        sync()
                        times.append((time.perf_counter() - t) * 1e3)
                        return out
                    return call

                detector_eval.make_predict_fn = timed_make
                wa.LAUNCHES.clear()
                wa.BWD_LAUNCHES.clear()
                t = time.perf_counter()
                out_dir = os.path.join(work, family, metric)
                with contextlib.redirect_stdout(io.StringIO()):
                    metrics = test_cli.main([
                        family, "--infos", infos, "--data-root",
                        frames_dir, "--ckpt-dir", lifted, "--metric",
                        metric, "--out-dir", out_dir, "--device", "cuda"])
                wall = time.perf_counter() - t
                no_kernel_launches(f"{family} eval {metric}")
                if len(times) != n:
                    raise AssertionError(f"{family} eval {metric}: "
                                         f"{len(times)} predicts for {n} "
                                         f"frames")
                if metric == "kitti":
                    shown = {k: v for k, v in metrics.items() if "_3d_" in k}
                    if len(shown) != 3:
                        raise AssertionError(f"{family} kitti {metrics}")
                else:
                    shown = {k: v for k, v in metrics.items()
                             if k.startswith("OBJECT_TYPE_TYPE_VEHICLE")}
                    preds = read_bin(os.path.join(out_dir, "pred.bin"))
                    if not shown or not preds:
                        raise AssertionError(
                            f"{family} waymo: {len(preds)} predictions, "
                            f"metrics {metrics}")
                    shown["predictions"] = len(preds)
                log(f"tools/test.py {family} --metric {metric}: {n} frames, "
                    f"wall {wall:.3f} s, predict "
                    f"{statistics.median(times):.3f} ms/frame (median; "
                    f"{[round(x, 3) for x in times]}), window-attention "
                    f"launches 0; {shown}; card {card_info()}")
    finally:
        detector_eval.make_predict_fn = make


def fsdpp_model(device):
    """The training CLI's full-width FSD++ with seeded random weights."""
    return bench.build_frame_detector("fsdpp", None, device, seed=0)


def count_line(counts):
    return ", ".join(f"{k} {int(v)}" for k, v in counts.items())


def phase_fsdpp(dev):
    """Full-width FSD++ inference over a sequence of ``FSDPP_FRAMES``
    synthetic frames through ``benchmark fsdpp`` (``make_sequential_
    predict_fn``, after an untimed warm-up; it checks the shapes and finite
    values): per frame the ms, the counts and the peak memory; 0
    window-attention launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    res = bench.bench_fsdpp(frames=FSDPP_FRAMES, device=dev)
    no_kernel_launches("fsdpp inference")
    rows = res["counts"]
    if len(rows) != FSDPP_FRAMES or rows[0]["cropped"] != 0 or not all(
            r["memory"] > 0 for r in rows):
        raise AssertionError(f"fsdpp counts {rows}")
    for i, (t, r, peak) in enumerate(zip(res["frame_ms"], rows,
                                         res["frame_peak_gib"])):
        log(f"fsdpp frame {i}: {t:.3f} ms, {count_line(r)}, peak memory "
            f"{peak:.3f} GiB")
    log(f"fsdpp inference: {FSDPP_FRAMES} frames of "
        f"{res['num_real_points']} points, {res['latency_ms']:.3f} ms/frame "
        f"(median from the third frame), peak memory "
        f"{res['peak_memory_gib']:.3f} GiB, window-attention launches 0; "
        f"card {card_info()}")


def slots_differ(a, b):
    return int((a.cpu() != b.cpu()).reshape(a.shape[0], -1).any(-1).sum())


def compare_fsdpp_state(what, card, cpu):
    """Slots of the memory update and of the seeds that differ, each
    against its bar; the agreeing seeds' boxes at ``FSD_BOX_RTOL``."""
    mem = max(slots_differ(card.memory, cpu.memory),
              slots_differ(card.memory_mask, cpu.memory_mask),
              slots_differ(card.memory_age, cpu.memory_age))
    seeds = int(((card.seeds.valid.cpu() != cpu.seeds.valid)
                 | (card.seeds.valid.cpu() & (card.seeds.labels.cpu()
                                              != cpu.seeds.labels))).sum())
    log(f"{what}: memory slots that differ {mem} (bar {FSDPP_MASK_SLOTS} of "
        f"{card.memory_mask.numel()}; {int(card.memory_mask.sum())} valid), "
        f"seed slots that differ {seeds} (bar {FSDPP_SEED_SLOTS} of "
        f"{card.seeds.valid.numel()}; {int(card.seeds.valid.sum())} valid)")
    if mem > FSDPP_MASK_SLOTS or seeds > FSDPP_SEED_SLOTS:
        raise AssertionError(f"{what}: {mem} memory, {seeds} seed slots")
    same = (card.seeds.valid.cpu() & cpu.seeds.valid
            & (card.seeds.labels.cpu() == cpu.seeds.labels))
    compare_fsd(what + ", seeds that agree",
                {"boxes": card.seeds.boxes[same.to(card.seeds.boxes.device)]},
                {"boxes": cpu.seeds.boxes[same]}, ("boxes",), FSD_BOX_RTOL)


def phase_fsdpp_card_vs_cpu(dev):
    """``FSDPP_CHECK_FRAMES`` full-width float32 frames (TF32 off), card
    against CPU, teacher-forced: both devices get the card's incoming
    state, grouping and pooled points at each frame."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, cpu = fsdpp_model(dev), fsdpp_model("cpu")
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    state = card.init_state(5)
    with torch.inference_mode():
        for i in range(FSDPP_CHECK_FRAMES):
            pts, msk = bench.frame_tensors(card.cfg, dev, 150000, i)
            record = []
            new_c, out_c = card(state, pts, msk, record=record)
            grouping, selection = to_cpu(*record[0])
            new_p, out_p = cpu(state.to("cpu"), pts.cpu(), msk.cpu(),
                               grouping=grouping, selection=selection)
            what = f"fsdpp frame {i} fp32, card vs CPU"
            n = pts.shape[0]
            keep_c, keep_p = out_c["input_mask"].cpu(), out_p["input_mask"]
            novel = int((keep_c[:n] != keep_p[:n]).sum())
            crop = int((keep_c[n:] != keep_p[n:]).sum())
            log(f"{what}: merged-mask slots that differ: novel {novel}, "
                f"crop {crop} (bar {FSDPP_MASK_SLOTS}; {int(keep_c[:n].sum())}"
                f" novel, {int(keep_c[n:].sum())} cropped on the card)")
            if novel + crop > FSDPP_MASK_SLOTS:
                raise AssertionError(f"{what}: merged mask {novel}, {crop}")
            compare_fsdpp_state(what, new_c, new_p)
            for key in ("cluster_valid", "roi_nonempty"):
                if not torch.equal(out_c[key].cpu(), out_p[key]):
                    raise AssertionError(f"{what}: {key} differs")
            compare_fsd(what, out_c, out_p, FSD_CLUSTER_KEYS + FSD2_KEYS)
            compare_fsd(what, out_c, out_p, FSD_BOX_KEYS + ("refined_boxes",),
                        FSD_BOX_RTOL)
            state = new_c
    no_kernel_launches("fsdpp card vs CPU")


def phase_fsdpp_training(dev, frames_dir, work):
    """``tools/train.py fsdpp``'s ``main`` at full width on the SST training
    phase's 3 frames: ``FSDPP_TRAIN_STEPS`` float32 windows of
    ``FSDPP_WINDOW`` frames, finite losses, every parameter moved but
    regression branches without positives, ms/step, peak memory."""
    infos = os.path.join(frames_dir, "infos.pkl")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    stamps, seen = [], []

    def hook(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        seen.append({k: float(v) for k, v in metrics.items()})

    out = os.path.join(work, "fsdpp")
    torch.cuda.reset_peak_memory_stats(dev)
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    t0 = time.perf_counter()
    done = train_cli.main([
        "fsdpp", "--infos", infos, "--data-root", frames_dir,
        "--total-steps", str(FSDPP_TRAIN_STEPS), "--seq-window",
        str(FSDPP_WINDOW), "--work-dir", out, "--device", "cuda", "--seed",
        "0"], hooks=[hook])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    no_kernel_launches("fsdpp training")
    keys = ("loss", "loss_seg", "loss_vote", "loss_cls", "loss_cls2",
            "loss_reg2", "loss_corner2", "grad_norm")
    if done != FSDPP_TRAIN_STEPS or len(seen) != FSDPP_TRAIN_STEPS or not all(
            abs(m[k]) < float("inf") for m in seen for k in keys):
        raise AssertionError(f"fsdpp training ran {len(seen)} steps: {seen}")
    for i, m in enumerate(seen):
        log(f"fsdpp training step {i + 1} " + " ".join(
            f"{k}={m[k]:.6f}" for k in keys + ("num_pos_clusters",
                                               "num_pos_rois2")))
    trained = torch.load(os.path.join(out, "ckpt",
                                      f"step_{FSDPP_TRAIN_STEPS}.pt"),
                         map_location="cpu", weights_only=True)["model"]
    init = fsdpp_model("cpu").state_dict()
    same = sorted(n for n, p in init.items() if torch.equal(p, trained[n]))
    if not all(any(r in n for r in FSD_REGRESSION)
               and (n.endswith("bias") or "LayerNorm" in n) for n in same):
        raise AssertionError(f"fsdpp parameters that did not move: {same}")
    times = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    timed = times[TRAIN_TIMED_FROM - 1:]
    log(f"fsdpp training: {FSDPP_TRAIN_STEPS} float32 windows of "
        f"{FSDPP_WINDOW} frames at full width through the CLI, "
        f"{statistics.median(timed):.3f} ms/step (median of steps "
        f"{TRAIN_TIMED_FROM}-{FSDPP_TRAIN_STEPS}; all "
        f"{[round(x, 3) for x in times]}), peak memory {peak:.3f} GiB, "
        f"window-attention launches 0, {len(init) - len(same)} of "
        f"{len(init)} parameter tensors moved (unmoved: {same}); card "
        f"{card_info()}")


def fsdpp_window(cfg, dev):
    """Two full-width synthetic frames with their boxes, each with offline
    seeds on its boxes (moved by up to 0.15 m)."""
    frames = [bench.train_batch(cfg, dev, 150000, seed=20 + i)
              for i in range(FSDPP_WINDOW)]
    gen = torch.Generator().manual_seed(0)
    s = cfg.max_seeds
    seeds = []
    for f in frames:
        boxes = torch.zeros((s, 7))
        n = min(int(f.gt_valid.sum()), s)
        boxes[:n] = f.gt_boxes[0, :n].cpu() + 0.3 * (
            torch.rand((n, 7), generator=gen) - 0.5)
        seeds.append((boxes, torch.zeros(s, dtype=torch.int32),
                      torch.full((s,), 0.5), torch.arange(s) < n))
    return SeqWindow(*(torch.cat(t, 0) for t in zip(*frames)),
                     *(torch.stack(t).to(dev) for t in zip(*seeds)))


def phase_fsdpp_fp32_step(dev):
    """One float32 FSD++ window step (TF32 off, lr ``CP_STEP_LR``) at full
    width on the card and on the CPU from the same weights and incoming
    state (one inference frame's), both fed the card's groupings and pooled
    points, the same offline seeds and seed-augmentation draws and the
    card's routes: the loss dict, every clipped gradient and every
    parameter after the update, at CenterPoint's bars."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    card = fsdpp_model(dev)
    batch = fsdpp_window(card.cfg, dev)
    with torch.inference_mode():
        state, _ = card(card.init_state(5),
                        *bench.frame_tensors(card.cfg, dev, 150000, 19))
    state = SequenceState(*(t.clone() for t in state[:3]),
                          seed_ops.Seeds(*(t.clone() for t in state.seeds)))
    gen = torch.Generator().manual_seed(1)
    noise = [seed_ops.draw_seed_noise(card.cfg.max_seeds, gen)
             for _ in range(FSDPP_WINDOW)]
    res, record = [], []
    for where in (dev, "cpu"):
        model = card if where == dev else fsdpp_model("cpu")
        model.train()
        init = {n: p.detach().cpu().clone()
                for n, p in model.named_parameters()}
        optimizer, schedule = make_optimizer(model.named_parameters(),
                                             CP_STEP_LR, 100)
        step_fn = make_seq_train_step(model, optimizer, schedule,
                                      FSDPP_WINDOW)
        if where == dev:
            with Routes() as routes:
                _, metrics = step_fn(0, batch, state, noise=[
                    seed_ops.SeedNoise(*(t.to(dev) for t in nz))
                    for nz in noise], record=record)
        else:
            with Routes([m.cpu() for m in routes.masks]) as fed:
                _, metrics = step_fn(0, batch.to("cpu"), state.to("cpu"),
                                     noise=noise, overrides=[
                                         to_cpu(g, s) for g, s in record])
        res.append(({k: float(v) for k, v in metrics.items()},
                    {n: (p.detach().cpu(), p.grad.cpu())
                     for n, p in model.named_parameters()}))
    no_kernel_launches("fsdpp fp32 step")
    log(f"fsdpp fp32 window step: {FSDPP_WINDOW} frames, "
        f"{int(batch.seed_valid.sum())} offline seeds, card's groupings fed "
        f"to the CPU ({len(record)} frames) and its {len(routes.masks)} "
        f"routes' {fed.fed} elements: {fed.flips} differ from the CPU's "
        f"own (bar {FSDPP_ROUTE_FLIPS:.0e} of those fed; (call, op, shape, "
        f"count): {fed.flipped})")
    if not fed.flips <= FSDPP_ROUTE_FLIPS * fed.fed:
        raise AssertionError(f"fsdpp fp32 window step: {fed.flips} of "
                             f"{fed.fed} route elements differ")
    check_step_card_vs_cpu("fsdpp fp32 window step", res, init, schedule(0))


def phase_fsdpp_eval(dev, frames_dir, work):
    """``tools/test.py fsdpp`` with ``--metric kitti`` and ``--metric
    waymo`` on the training phase's checkpoint (biases lifted by
    ``FSD_EVAL_LIFT``) and frames: the sequence step's ms per frame under
    the CLI; 0 window-attention launches."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    infos = os.path.join(frames_dir, "infos.pkl")
    n = len(FrameDataset(infos, frames_dir))
    make = detector_eval.make_sequential_predict_fn
    lifted, keys = lift_fsd_checkpoint(work, "fsdpp")
    log(f"fsdpp evaluation: {FSD_EVAL_LIFT} added to {keys}")
    times = []

    def timed_make(model):
        fn = make(model)

        def call(state, points, mask):
            sync()
            t = time.perf_counter()
            out = fn(state, points, mask)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            return out
        return call

    try:
        detector_eval.make_sequential_predict_fn = timed_make
        for metric in ("kitti", "waymo"):
            times.clear()
            wa.LAUNCHES.clear()
            wa.BWD_LAUNCHES.clear()
            t = time.perf_counter()
            out_dir = os.path.join(work, "fsdpp", metric)
            with contextlib.redirect_stdout(io.StringIO()):
                metrics = test_cli.main([
                    "fsdpp", "--infos", infos, "--data-root", frames_dir,
                    "--ckpt-dir", lifted, "--metric", metric, "--out-dir",
                    out_dir, "--device", "cuda"])
            wall = time.perf_counter() - t
            no_kernel_launches(f"fsdpp eval {metric}")
            if len(times) != n:
                raise AssertionError(f"fsdpp eval {metric}: {len(times)} "
                                     f"steps for {n} frames")
            if metric == "kitti":
                shown = {k: v for k, v in metrics.items() if "_3d_" in k}
                if len(shown) != 3:
                    raise AssertionError(f"fsdpp kitti {metrics}")
            else:
                shown = {k: v for k, v in metrics.items()
                         if k.startswith("OBJECT_TYPE_TYPE_VEHICLE")}
                preds = read_bin(os.path.join(out_dir, "pred.bin"))
                if not shown or not preds:
                    raise AssertionError(f"fsdpp waymo: {len(preds)} "
                                         f"predictions, metrics {metrics}")
                shown["predictions"] = len(preds)
            log(f"tools/test.py fsdpp --metric {metric}: {n} frames of one "
                f"segment, wall {wall:.3f} s, sequence step "
                f"{statistics.median(times):.3f} ms/frame (median; "
                f"{[round(x, 3) for x in times]}), window-attention "
                f"launches 0; {shown}; card {card_info()}")
    finally:
        detector_eval.make_sequential_predict_fn = make


def write_occ_predictions(frames_dir, occ_root):
    """Seeded ``[W8_OCC_ROWS, 4]`` float32 files in ``save_occ``'s layout,
    one per GT box of each frame: centres inside the box and a score.
    Returns the rows written per frame."""
    ds = FrameDataset(os.path.join(frames_dir, "infos.pkl"), frames_dir)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for i, info in enumerate(ds.infos):
        d = os.path.join(occ_root, info["segment_name"],
                         str(info["timestamp"]))
        os.makedirs(d, exist_ok=True)
        s = ds.build_sample(i, np.random.RandomState(0))
        boxes = torch.from_numpy(s["gt_boxes"][s["gt_valid"]])
        for j, b in enumerate(boxes):
            local = (torch.rand((W8_OCC_ROWS, 3), generator=gen) - 0.5) \
                * b[3:6]
            c, sn = torch.cos(b[6]), torch.sin(b[6])
            xyz = torch.stack([local[:, 0] * c - local[:, 1] * sn + b[0],
                               local[:, 0] * sn + local[:, 1] * c + b[1],
                               local[:, 2] + b[2] + b[5] / 2], -1)
            occ = torch.cat([xyz, torch.rand((W8_OCC_ROWS, 1),
                                             generator=gen)], -1)
            occ.numpy().astype(np.float32).tofile(
                os.path.join(d, f"1_{j}.bin"))
        rows.append(len(boxes) * W8_OCC_ROWS)
    return rows


def phase_w8_training(dev, frames_dir, work):
    """``tools/train.py fsd2 --occ-pred-root`` for ``W8_TRAIN_STEPS``
    float32 steps on the SST training phase's frames with seeded occupancy
    files: the merged point counts, finite losses, ms/step."""
    infos = os.path.join(frames_dir, "infos.pkl")
    occ_root = os.path.join(work, "occ_pred")
    rows = write_occ_predictions(frames_dir, occ_root)
    plain = FrameDataset(infos, frames_dir)
    merged = FrameDataset(infos, frames_dir, occ_pred_root=occ_root)
    for i, r in enumerate(rows):
        a = int(plain.build_sample(i, np.random.RandomState(0))
                ["points_mask"].sum())
        b = int(merged.build_sample(i, np.random.RandomState(0))
                ["points_mask"].sum())
        log(f"W8 frame {i}: {a} points, {r} predicted occupancy points, "
            f"{b} merged (budget {merged.max_points})")
        if b != min(a + r, merged.max_points) or r == 0:
            raise AssertionError(f"W8 frame {i}: {a} + {r} -> {b}")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    stamps, seen = [], []

    def hook(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        seen.append({k: float(v) for k, v in metrics.items()})

    torch.cuda.reset_peak_memory_stats(dev)
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    t0 = time.perf_counter()
    done = train_cli.main([
        "fsd2", "--infos", infos, "--data-root", frames_dir,
        "--occ-pred-root", occ_root, "--total-steps", str(W8_TRAIN_STEPS),
        "--log-interval", "1", "--work-dir", os.path.join(work, "w8"),
        "--device", "cuda", "--seed", "0"], hooks=[hook])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    no_kernel_launches("W8 training")
    keys = ("loss", "loss_seg", "loss_cls2", "grad_norm")
    if done != W8_TRAIN_STEPS or len(seen) != W8_TRAIN_STEPS or not all(
            abs(m[k]) < float("inf") for m in seen for k in keys):
        raise AssertionError(f"W8 training ran {len(seen)} steps: {seen}")
    times = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    log(f"W8 training (fsd2 on predicted occupancy): {W8_TRAIN_STEPS} "
        f"float32 steps at full width through the CLI, "
        f"{statistics.median(times[TRAIN_TIMED_FROM - 1:]):.3f} ms/step "
        f"(median from step {TRAIN_TIMED_FROM}; all "
        f"{[round(x, 3) for x in times]}), losses "
        f"{[round(m['loss'], 4) for m in seen]}, peak memory {peak:.3f} GiB, "
        f"window-attention launches 0; card {card_info()}")


def annotate_visibility_check(dev, boxes, frames):
    """The TOP LiDAR's visibility test over every voxel of the benchmark
    scene's grid, its range images scaled by ``ANNOTATE_BLOCK_SCALE`` so
    that some voxels are blocked in every frame: the card against the CPU
    under the margin rule. Returns (voxels, free share, differing,
    unexplained)."""
    size = boxes[:, 3:6].max(0)
    dims = np.maximum(np.ceil(size / 0.2).astype(np.int32), 1)
    idx = np.stack(np.nonzero(np.ones(tuple(dims), bool)), -1)
    min_bound = np.array([-size[0] / 2, -size[1] / 2, 0.0])
    centers = ((idx + 0.5) * 0.2 + min_bound).astype(np.float32)
    extr, incl, ri = (np.stack(a, 0) for a in zip(
        *[annotate.staged_inputs(f, "TOP") for f in frames]))
    ri = ri * np.float32(ANNOTATE_BLOCK_SCALE)
    inputs = (centers, np.asarray(boxes, np.float32), extr, incl, ri)
    vis = {where: annotate._range_image_visibility(
        *(torch.from_numpy(a).to(where) for a in inputs)).cpu().numpy()
        for where in (dev, "cpu")}
    diff = np.nonzero(vis[dev] != vis["cpu"])[0]
    bad = 0
    if len(diff):
        sub = (centers[diff],) + inputs[1:]
        bad = int(annotate.unexplained(
            vis[dev][diff], vis["cpu"][diff],
            [annotate.decision_margins(*sub)]).sum())
    return len(centers), float((vis["cpu"] == 2).mean()), len(diff), bad


def phase_annotator(dev):
    """W1 at the benchmark scene's full size (``scenes.make_realistic_
    scene``: 100 frames of 160,000 points, five LiDARs, TOP 64 x 2650)
    through ``OccAnnotator`` on the card and on the CPU: the grids must
    agree under the margin rule; ms per tracklet with its split; no
    window-attention launch."""
    boxes, ts_list, get_points, get_raw_frame = scenes.make_realistic_scene()
    frames = [get_raw_frame(ts) for ts in ts_list]
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats(dev)
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        card = annotate.OccAnnotator(get_points, get_raw_frame,
                                     os.path.join(tmp, "card"),
                                     overwrite=True, device=dev)
        t0 = time.perf_counter()
        path = card.annotate_trk("seg", "trk", boxes, ts_list)
        first_ms = (time.perf_counter() - t0) * 1e3
        occ_card = np.load(path)["occ"]
        for k in card.timing:
            card.timing[k] = 0.0
        times = []
        for i in range(ANNOTATE_TIMED):
            t0 = time.perf_counter()
            card.annotate_trk("seg", f"trk{i}", boxes, ts_list)
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        no_kernel_launches("the annotator")
        split = {k: (v * 1e3 if k.endswith("_s") else v) / ANNOTATE_TIMED
                 for k, v in card.timing.items()}
        t0 = time.perf_counter()
        cpu = annotate.OccAnnotator(get_points, get_raw_frame,
                                    os.path.join(tmp, "cpu"), device="cpu")
        occ_cpu = np.load(cpu.annotate_trk("seg", "trk", boxes,
                                           ts_list))["occ"]
        cpu_ms = (time.perf_counter() - t0) * 1e3
    diff = annotate.grid_differences(occ_card, occ_cpu, boxes, frames, 0.2)
    counts = [int((occ_card == v).sum()) for v in (0, 1, 2)]
    log(f"annotator: grid {list(occ_card.shape)}, unknown/occupied/free "
        f"{counts}, card vs CPU {diff} (bar: no unexplained voxel)")
    if diff["unexplained"]:
        raise AssertionError(f"annotator grids, card vs CPU: {diff}")
    n, free, differ, bad = annotate_visibility_check(dev, boxes, frames)
    log(f"annotator: TOP visibility with range images x "
        f"{ANNOTATE_BLOCK_SCALE} over {n} voxels x {len(frames)} frames: "
        f"free {free:.3f}, card vs CPU differ {differ}, unexplained {bad}")
    if bad or not 0.05 < free < 0.95:
        raise AssertionError(f"annotator visibility check: {differ} differ, "
                             f"{bad} unexplained, free {free}")
    log(f"annotator: {statistics.median(times):.3f} ms/tracklet on the card "
        f"(median of {ANNOTATE_TIMED} after one of {first_ms:.3f} ms that "
        f"staged the range images; all {[round(x, 3) for x in times]}): "
        f"host gather and voxelize {split['gather_s']:.3f}, visibility "
        f"{split['visibility_s']:.3f} (device {split['device_ms']:.3f}), "
        f"npz write {split['write_s']:.3f} ms per tracklet; peak memory "
        f"{peak:.3f} GiB; the CPU's tracklet {cpu_ms:.3f} ms; "
        f"window-attention launches 0; card {card_info()}")


def create_data_cli(argv, what):
    """``tools/create_data.py`` in a subprocess from the checkout's root;
    returns its output."""
    res = subprocess.run(
        [sys.executable, "-m",
         "objectcentricocccompletion_torch.tools.create_data"] + argv,
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=CREATE_DATA_TIMEOUT)
    if res.returncode:
        raise AssertionError(f"{what}: exit {res.returncode}\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return res.stdout


def phase_data_prep(dev):
    """The data-prep CLI end to end: ``occ_annotate --workers 2`` on the
    card and on the CPU (the npz files equal), then ``tracklets``; the
    tracklet dataset loads in ``TrackletDataset`` with the card's grids."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        p = scenes.write_annotation_dataset(os.path.join(tmp, "data"),
                                            **ANNOTATE_DATA)
        write_s = time.perf_counter() - t0
        common = ["--gt-bin", p["gt_bin"], "--infos", p["infos"],
                  "--data-root", p["data_root"], "--raw-root", p["raw_root"],
                  "--workers", "2"]
        grids, walls = {}, {}
        for where in ("cuda", "cpu"):
            out = os.path.join(tmp, f"occ_{where}")
            t0 = time.perf_counter()
            create_data_cli(["occ_annotate", *common, "--out-dir", out,
                             "--device", where], f"occ_annotate {where}")
            walls[where] = time.perf_counter() - t0
            grids[where] = {os.path.relpath(f, out): np.load(f)["occ"]
                            for f in sorted(glob.glob(
                                os.path.join(out, "*", "*.npz")))}
        n_trk = ANNOTATE_DATA["segments"] * \
            ANNOTATE_DATA["tracklets_per_segment"]
        if sorted(grids["cuda"]) != sorted(grids["cpu"]) or \
                len(grids["cuda"]) != n_trk:
            raise AssertionError(f"occ_annotate files: card "
                                 f"{sorted(grids['cuda'])}, CPU "
                                 f"{sorted(grids['cpu'])}")
        unequal = [k for k, g in grids["cuda"].items()
                   if g.dtype != grids["cpu"][k].dtype
                   or g.tobytes() != grids["cpu"][k].tobytes()]
        counts = np.sum([[int((g == v).sum()) for v in (0, 1, 2)]
                         for g in grids["cuda"].values()], 0).tolist()
        log(f"data prep: {n_trk} tracklets annotated by the CLI with "
            f"--workers 2 in {walls['cuda']:.1f} s on the card, "
            f"{walls['cpu']:.1f} s on the CPU (inputs written in "
            f"{write_s:.1f} s); unknown/occupied/free {counts}; npz files "
            f"that differ: {unequal}")
        if unequal or not counts[1] or not counts[2]:
            raise AssertionError(f"occ_annotate card vs CPU: {unequal} "
                                 f"differ; counts {counts}")
        trk = os.path.join(tmp, "trk")
        t0 = time.perf_counter()
        create_data_cli(["tracklets", "--pred-bin", p["pred_bin"],
                         "--gt-bin", p["gt_bin"], "--infos", p["infos"],
                         "--data-root", p["data_root"], "--out-dir", trk],
                        "tracklets")
        trk_s = time.perf_counter() - t0
        ds = TrackletDataset(
            proposals_file=os.path.join(trk, "proposals.pkl"),
            gt_candidates_file=os.path.join(trk, "gt_candidates.pkl"),
            pose_file=os.path.join(trk, "poses.pkl"),
            occ_anno_root=os.path.join(tmp, "occ_cuda"),
            cfg=train_cli.ococc_train_config(), min_tracklet_length=1,
            min_tracklet_points=1)
        s = ds.build_sample(0, np.random.RandomState(0))
        if len(ds) != n_trk or not s["points_mask"].any() or \
                not s["gt_valid"].any() or not s["occ_score"] > 0:
            raise AssertionError(f"tracklet dataset: {len(ds)} tracklets, "
                                 f"sample {s['meta']}, occ score "
                                 f"{s['occ_score']}")
    log(f"data prep: tracklets CLI {trk_s:.1f} s; TrackletDataset loads "
        f"{len(ds)} tracklets, a sample with "
        f"{int(s['points_mask'].sum())} points and occupancy score "
        f"{float(s['occ_score'])}")


def step_launches(name, t0, stamps, expect):
    """Each step's ms from ``stamps`` (``(time, forward counts, backward
    counts)`` after every step, the run started at ``t0``); every step must
    launch ``expect`` forward and backward kernels per level."""
    prev, times = (t0, {}, {}), []
    for step, (now, f, b) in enumerate(stamps, 1):
        df = {T: n - prev[1].get(T, 0) for T, n in f.items()}
        db = {T: n - prev[2].get(T, 0) for T, n in b.items()}
        if df != expect or db != expect:
            raise AssertionError(f"{name} step {step}: forward {df}, "
                                 f"backward {db}, expected {expect}")
        times.append((now - prev[0]) * 1e3)
        prev = (now, f, b)
    return times


def phase_aug_training(dev, frames_dir, work):
    """``tools/train.py sst`` at ``SSTDetectorConfig()`` (float32) with
    ``AUG_ARGS`` for ``AUG_TRAIN_STEPS`` steps on the SST training phase's
    frames: 6-wide points, 12 forward and 12 backward launches per level
    per step, finite losses, augmentation and GT paste off from step 2
    (counted from 0); the host ms per frame of both beside the step's ms.
    Returns the launch counts (forward, backward)."""
    infos = os.path.join(frames_dir, "infos.pkl")
    per_level = 2 * bench.sst_config().sst.num_blocks
    expect = {32: per_level, 144: per_level}
    build, augment, paste = (tfd.FrameDataset.build_sample,
                             tfd.FrameDataset._augment, tfd.apply_db_sample)
    host = collections.Counter()
    draws = []

    def timed(key, fn):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            host[key] += time.perf_counter() - t
            return out
        return run

    def record(self, index, rng):
        before = dict(host)
        s = timed("build", build)(self, index, rng)
        draws.append((self.augment, self.db_sampler is not None,
                      s["points"].shape, {k: host[k] - before.get(k, 0.0)
                                          for k in host}))
        return s

    stamps = []

    def hook(step, metrics):
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), dict(wa.LAUNCHES),
                       dict(wa.BWD_LAUNCHES)))

    argv = ["sst", "--infos", infos, "--data-root", frames_dir,
            "--total-steps", str(AUG_TRAIN_STEPS), "--log-interval", "1",
            "--work-dir", os.path.join(work, "aug"), "--device", "cuda",
            "--seed", "0", *AUG_ARGS]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    def pasting(sample, sampler):
        out = timed("paste", paste)(sample, sampler)
        host["pasted"] += int(out["gt_valid"].sum() -
                              sample["gt_valid"].sum())
        return out

    tfd.FrameDataset.build_sample = record
    tfd.FrameDataset._augment = timed("augment", augment)
    tfd.apply_db_sample = pasting
    try:
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        t0 = time.perf_counter()
        done = train_cli.main(argv, hooks=[hook])
    finally:
        tfd.FrameDataset.build_sample = build
        tfd.FrameDataset._augment = augment
        tfd.apply_db_sample = paste
    fwd, bwd = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
    train = draws[-AUG_TRAIN_STEPS:]
    flags = [d[:2] for d in train]
    want = [(True, True)] * 2 + [(False, False)] * (AUG_TRAIN_STEPS - 2)
    if done != AUG_TRAIN_STEPS or flags != want or \
            any(d[2][1] != 6 for d in draws):
        raise AssertionError(f"augmented training: {done} steps, draws "
                             f"{[d[:3] for d in draws]}")
    times = step_launches("augmented training", t0, stamps, expect)
    rows = [json.loads(line) for line in open(
        os.path.join(work, "aug", "metrics.jsonl"))]
    keys = ("loss", "loss_cls", "loss_bbox", "loss_dir", "grad_norm")
    if len(rows) != AUG_TRAIN_STEPS or not all(
            abs(r[k]) < float("inf") for r in rows for k in keys):
        raise AssertionError(f"augmented training metrics {rows}")
    trained = torch.load(os.path.join(work, "aug", "ckpt",
                                      f"step_{AUG_TRAIN_STEPS}.pt"),
                         map_location="cpu", weights_only=True)["model"]
    width = trained["backbone.vfe.vfe_0.weight"].shape[1]
    if width != 6 + 6:
        raise AssertionError(f"the VFE's first Dense takes {width} inputs")
    on = [d[3] for d in train if d[0]]
    aug_ms = [1e3 * d.get("augment", 0.0) for d in on]
    paste_ms = [1e3 * d.get("paste", 0.0) for d in on]
    build_ms = [1e3 * d[3]["build"] for d in train]
    log(f"augmented training (sst float32, {' '.join(AUG_ARGS)}): "
        f"{AUG_TRAIN_STEPS} steps at full width, ms/step "
        f"{[round(x, 3) for x in times]} (median from step "
        f"{TRAIN_TIMED_FROM}: {statistics.median(times[TRAIN_TIMED_FROM - 1:]):.3f}"
        f"); host ms per frame while on (steps 1-2): augmentation "
        f"{[round(x, 3) for x in aug_ms]}, GT paste "
        f"{[round(x, 3) for x in paste_ms]} ("
        f"{[int(d.get('pasted', 0)) for d in on]} objects pasted); the "
        f"whole sample build (the frame, its sweeps in its pose, paste "
        f"and augmentation) "
        f"{[round(x, 3) for x in build_ms]} ms per frame; points "
        f"{train[0][2]}, VFE "
        f"input {width}; losses {[round(r['loss'], 4) for r in rows]}; "
        f"launches forward {fwd} backward {bwd}; card {card_info()}")
    return fwd, bwd


def seg_config(**kw):
    """CTRL vehicle with the full segmentor (``TrackletSegmentorConfig()``:
    0.25 m voxels over +-100 m x +-10 m, 16,384 voxels)."""
    return dataclasses.replace(ctrl_veh_config(), use_segmentor="full", **kw)


def phase_ctrl_segmentor(dev, occ_dir):
    """A. CTRL vehicle with the full segmentor: serving in float32 and bf16
    (packed layout, batch 4 of 32 frames x 1,024 point slots: 32,768 points
    through the segmentor per tracklet), the segmentor's voxels per
    tracklet against its budget; one tracklet's predict and float32
    training step (TF32 off, dropout 0) card against CPU, the card's routes
    fed to the CPU; then ``SEG_TRAIN_STEPS`` steps of
    ``training/trainer.py::train`` on phase 8's tracklets. No hand-written
    kernel lies on the path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    for dtype in ("float32", "bfloat16"):
        res = bench.bench_ococcnet(SEG_TIMED, dtype, "packed", dev,
                                   cfg=seg_config())
        log(f"ctrl + segmentor serving ({dtype}, packed, batch "
            f"{res['batch']}): {res['latency_ms']:.3f} ms per batch "
            f"(median of {SEG_TIMED}), {res['fps']:.2f} tracklets/s, peak "
            f"memory {res['peak_memory_gib']:.3f} GiB; segmentor voxels per "
            f"tracklet {res['segmentor_voxels']} of "
            f"{res['segmentor_max_voxels']}; card {res['card']}")
    cfg = seg_config(base_lr=CP_STEP_LR, **NO_DROPOUT)
    batch = TrackletBatch(*(x[:1] for x in synthetic_batch(
        cfg, batch_size=bench.OCC_BATCH, seed=0)))
    card = OcOccNetWithLoss(cfg, dev, torch.Generator().manual_seed(0))
    cpu = OcOccNetWithLoss(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    with torch.no_grad():
        got = card.predict(batch.to(dev))
        ref = cpu.predict(batch)
    compare_outputs("ctrl + segmentor predict fp32, card vs CPU", got, ref,
                    ("cls_logit", "bbox_pred", "boxes", "scores"))
    res = []
    for where in (dev, torch.device("cpu")):
        model, optimizer, schedule = create_train_state(cfg, 100, where, 0)
        init = {n: p.detach().cpu().clone()
                for n, p in model.named_parameters()}
        step_fn = make_train_step(model, optimizer, schedule)
        if where == dev:
            with Routes() as routes:
                metrics = step_fn(0, batch)
        else:
            with Routes([m.cpu() for m in routes.masks]) as fed:
                metrics = step_fn(0, batch)
        res.append(({k: float(v) for k, v in metrics.items()},
                    {n: (p.detach().cpu(), p.grad.cpu())
                     for n, p in model.named_parameters()}))
    seg = [n for n in res[1][1] if ".segmentor." in n]
    log(f"ctrl + segmentor fp32 step: the card's {len(routes.masks)} routes' "
        f"{fed.fed} elements fed to the CPU, {fed.flips} differ from its "
        f"own (bar {FSDPP_ROUTE_FLIPS:.0e} of those fed; {fed.flipped}); "
        f"{len(seg)} of {len(res[1][1])} parameter tensors in the segmentor")
    if not fed.flips <= FSDPP_ROUTE_FLIPS * fed.fed:
        raise AssertionError(f"ctrl + segmentor step: {fed.flips} of "
                             f"{fed.fed} route elements differ")
    check_step_card_vs_cpu("ctrl + segmentor fp32 step", res, init,
                           schedule(0))
    del card, model, optimizer
    torch.cuda.empty_cache()

    cfg = seg_config()
    ds = TrackletDataset(**dataset_paths(os.path.join(occ_dir, "data")),
                         cfg=cfg, class_names=cfg.class_names)
    stamps = []

    def hook(step, metrics):
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), float(metrics["loss"])))

    with tempfile.TemporaryDirectory() as work:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        done = train_tracklets(cfg, ds, work, total_steps=SEG_TRAIN_STEPS,
                               log_interval=1, device=dev, hooks=[hook])
        if done != SEG_TRAIN_STEPS or not os.path.exists(
                os.path.join(work, "ckpt", f"step_{SEG_TRAIN_STEPS}.pt")):
            raise AssertionError(f"ctrl + segmentor training ran {done}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses = [x for _, x in stamps]
    if not all(abs(x) < float("inf") for x in losses):
        raise AssertionError(f"ctrl + segmentor training losses {losses}")
    times = [(b - a) * 1e3 for a, b in zip([t0] + [t for t, _ in stamps],
                                          [t for t, _ in stamps])]
    no_kernel_launches("ctrl + segmentor")
    log(f"ctrl + segmentor training (training/trainer.py::train, float32, "
        f"batch {cfg.batch_size}, config dropout): ms/step "
        f"{[round(x, 3) for x in times]} (the first builds the model), "
        f"losses {[round(x, 4) for x in losses]}, peak memory {peak:.3f} "
        f"GiB; window-attention launches 0; card {card_info()}")


def phase_remat(dev):
    """B. The dense-layout float32 OcOccNet step (TF32 off, dropout 0,
    ``roi_point_budget`` 640) with and without ``remat_sir`` on the
    benchmark's batch: every gradient within ``OCC_STEP_GRAD_ATOL``; ms
    per forward + backward and the peak memory of each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(OcOccNetConfig(), packed_point_budget=None,
                              **NO_DROPOUT)
    batch = synthetic_batch(cfg, batch_size=bench.OCC_BATCH, seed=0).to(dev)
    grads, rows = {}, {}
    for remat in (False, True):
        model = OcOccNetWithLoss(dataclasses.replace(cfg, remat_sir=remat),
                                 dev, torch.Generator().manual_seed(0))
        model.train()

        def step():
            model.zero_grad(set_to_none=True)
            total, _ = model(batch)
            total.backward()

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = bench.time_calls(step, REMAT_STEPS, dev, warmup=0)
        rows[remat] = (statistics.median(times),
                       torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        grads[remat] = {n: p.grad.detach().clone()
                        for n, p in model.named_parameters()}
        del model
        torch.cuda.empty_cache()
    err = max((float((g - grads[False][n]).abs().max()), n)
              for n, g in grads[True].items())
    (ms0, gib0), (ms1, gib1) = rows[False], rows[True]
    log(f"remat_sir (dense float32 step, batch {bench.OCC_BATCH}): without "
        f"{ms0:.3f} ms, peak {gib0:.3f} GiB; with {ms1:.3f} ms, peak "
        f"{gib1:.3f} GiB ({100 * (gib0 - gib1) / gib0:.1f}% lower peak, "
        f"{100 * (ms1 - ms0) / ms0:.1f}% more time; medians of "
        f"{REMAT_STEPS} steps); gradients: worst {err[1]} at {err[0]:.3e} "
        f"(tolerance {OCC_STEP_GRAD_ATOL}); card {card_info()}")
    if not err[0] <= OCC_STEP_GRAD_ATOL:
        raise AssertionError(f"remat gradients: {err}")


def run_bounded(argv, what, timeout=LOADER_WAIT):
    """``argv`` in a subprocess that leads its own process group, from the
    repository's root, its output printed; the whole group (with the
    worker pool it started) is killed at ``timeout`` seconds, which fails
    the phase."""
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        raise AssertionError(f"{what}: no end within {timeout} s; its "
                             f"output ends {out[-3000:]}")
    log(out.rstrip())
    if proc.returncode:
        raise AssertionError(f"{what}: exit {proc.returncode}")
    return out


def check_worker_batches(data_root, batch_size):
    """``PrefetchLoader`` with ``LOADER_WORKERS`` spawned processes: its
    first ``LOADER_CHECK_BATCHES`` batches against a serial rebuild of its
    (index, seed) schedule (run by ``phase_loader_workers`` in a process
    of its own)."""
    cfg = train_cli.ococc_train_config(dtype="bfloat16")
    ds = TrackletDataset(**dataset_paths(data_root), cfg=cfg,
                         class_names=cfg.class_names)
    rng, order, tasks = np.random.RandomState(0), [], []
    for _ in range(LOADER_CHECK_BATCHES * batch_size):
        if not order:
            order = list(rng.permutation(len(ds)))
        tasks.append((order.pop(), int(rng.randint(0, 2 ** 31 - 1))))
    t0 = time.perf_counter()
    loader = PrefetchLoader(ds, batch_size, seed=0, workers=LOADER_WORKERS,
                            prefetch=2, timeout=LOADER_WAIT / 2)
    try:
        batches = [next(loader) for _ in range(LOADER_CHECK_BATCHES)]
    finally:
        loader.close()
    first_s = time.perf_counter() - t0
    for i, batch in enumerate(batches):
        ref = [ds.build_sample(idx, np.random.RandomState(seed))
               for idx, seed in tasks[i * batch_size:(i + 1) * batch_size]]
        for name, got in zip(batch._fields, batch):
            if not np.array_equal(got.numpy(),
                                  np.stack([r[name] for r in ref])):
                raise AssertionError(f"worker batch {i} {name} differs "
                                     f"from the serial rebuild")
    log(f"loader workers: {LOADER_CHECK_BATCHES} batches of {batch_size} "
        f"from {LOADER_WORKERS} spawned workers equal the serial rebuild of "
        f"their (index, seed) schedule ({first_s:.1f} s with the pool's "
        f"start)")


def phase_loader_workers(dev, occ_dir):
    """C. The worker pool, each run in a process of its own (as a user runs
    the CLI; every run bounded by ``LOADER_WAIT`` seconds):
    ``check_worker_batches``; then ``python -m ...tools.train ococcnet`` at
    full width (bf16, batch 4) with ``--loader-workers`` and with the
    thread prefetcher, ``LOADER_STEPS`` steps each (ms per step from the
    logged tracklets/s), beside the benchmark's step on one fixed batch
    in this process."""
    data = os.path.join(occ_dir, "data")
    paths = dataset_paths(data)
    batch = train_cli.ococc_train_config().batch_size
    torch.cuda.empty_cache()
    run_bounded([sys.executable, "-c", "import chip_smoke; chip_smoke."
                 f"check_worker_batches({data!r}, {batch})"],
                "the worker batches' check")
    rows = {}
    with tempfile.TemporaryDirectory() as work:
        for name, extra in (("thread prefetcher", []),
                            (f"{LOADER_WORKERS} workers",
                             ["--loader-workers", str(LOADER_WORKERS)])):
            run_dir = os.path.join(work, name.replace(" ", "_"))
            t0 = time.perf_counter()
            run_bounded([sys.executable, "-m",
                         "objectcentricocccompletion_torch.tools.train",
                         "ococcnet", *tracklet_flags(paths), "--total-steps",
                         str(LOADER_STEPS), "--log-interval", "1",
                         "--work-dir", run_dir, "--device", "cuda",
                         "--seed", "0", "--dtype", "bfloat16", *extra],
                        f"ococcnet CLI with the {name}")
            wall = time.perf_counter() - t0
            logged = [json.loads(line) for line in open(
                os.path.join(run_dir, "metrics.jsonl"))]
            if [r["step"] for r in logged] != list(
                    range(1, LOADER_STEPS + 1)) or not all(
                    abs(r["loss"]) < float("inf") for r in logged):
                raise AssertionError(f"{name}: metrics {logged}")
            ms = [batch * 1e3 / r["tracklets_per_sec"] for r in logged]
            rows[name] = statistics.median(ms[TRAIN_TIMED_FROM - 1:])
            log(f"ococcnet CLI with the {name}: {rows[name]:.3f} ms/step "
                f"(median of steps {TRAIN_TIMED_FROM}-{LOADER_STEPS}; all "
                f"{[round(x, 3) for x in ms]}), {wall:.1f} s of wall with "
                f"the process's start")
    bench_step = bench.bench_ococcnet_train(LOADER_STEPS - 2, "bfloat16",
                                            "packed", dev)["step_ms"]
    log(f"loader workers: the CLI's ms/step {rows} (bf16, batch {batch}, "
        f"full width, one call); the benchmark's step on one fixed batch "
        f"{bench_step:.3f} ms; card {card_info()}")


def phase_votenet(dev, keep):
    """D. VoteNet at the full width of ``VoteNetConfig()``: ms per frame
    and per step, the peak memory and the furthest point samplings' share
    (``benchmark votenet``); predict on a ScanNet and a SUN RGB-D scene
    (float32, TF32 off) card against CPU, the card's picks fed to the CPU
    (at most ``FSDPP_ROUTE_FLIPS`` of them differing from the CPU's own);
    ``tools/train.py votenet`` on written ScanNet and SUN RGB-D scenes and
    ``tools/test.py votenet`` on each checkpoint. No hand-written kernel
    lies on the path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    for train in (False, True):
        res = bench.bench_votenet(VOTE_TIMED, train, "scannet", dev,
                                  profile_n=1)
        unit = "step" if train else "frame"
        log(f"votenet {res['mode']} (scannet, {res['num_classes']} classes, "
            f"{res['points']} points): {res[f'ms_per_{unit}']:.3f} ms per "
            f"{unit} (median of {VOTE_TIMED}), peak memory "
            f"{res['peak_memory_gib']:.3f} GiB; kernels and copies per "
            f"{unit} {res[f'device_calls_per_{unit}']:.0f}, device busy "
            f"{res[f'device_busy_ms_per_{unit}']:.3f} ms "
            f"(share {res['device_busy_share']:.3f}); furthest point "
            f"sampling: stages {res['fps_stages']}, ms "
            f"{[round(x, 3) for x in res['fps_ms_by_stage']]} "
            f"({res['fps_ms_per_frame']:.3f} per forward), "
            f"{res['fps_steps_per_frame']} host steps of "
            f"{res['fps_kernels_per_step']} kernels: "
            f"{res['fps_launches_per_frame']:.0f} launches per forward; "
            f"card {res['card']}")
    for dataset in ("scannet", "sunrgbd"):
        card = bench.build_votenet(dataset, dev, 0)
        cpu = bench.build_votenet(dataset, "cpu", 0)
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        batch = bench.indoor_batch(dataset, "cpu", seed=3)
        points, mask = batch.points[0], batch.points_mask[0]
        with torch.no_grad():
            with Routes() as picks:
                got = card(points.to(dev), mask.to(dev))
            with Routes([p.cpu() for p in picks.masks]) as fed:
                ref = cpu(points, mask)
        log(f"votenet {dataset} predict fp32, card vs CPU: the card's "
            f"{len(picks.masks)} picks ({fed.fed} elements) fed to the CPU; "
            f"{fed.flips} differ from the CPU's own (bar "
            f"{FSDPP_ROUTE_FLIPS:.0e} of those fed; (call, kind, shape, "
            f"count): {fed.flipped})")
        if not fed.flips <= FSDPP_ROUTE_FLIPS * fed.fed:
            raise AssertionError(f"votenet {dataset} predict: {fed.flips} "
                                 f"of {fed.fed} pick elements differ")
        compare_outputs(f"votenet {dataset} predict fp32, card vs CPU", got,
                        ref, ("vote_xyz", "obj", "boxes", "sem"))
        del card, cpu
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    for dataset, yawed, ncls in (("scannet", False, 18),
                                 ("sunrgbd", True, 10)):
        root = os.path.join(keep, dataset)
        info = write_indoor_scenes(root, VOTE_SCENES, bench.INDOOR_POINTS,
                                   yawed, seed=int(yawed))
        work = os.path.join(root, "work")
        common = ["votenet", "--dataset", dataset, "--infos", info,
                  "--data-root", root, "--device", "cuda"]
        stamps = []

        def hook(step, metrics):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        t0 = time.perf_counter()
        done = train_cli.main(common + [
            "--total-steps", str(VOTE_TRAIN_STEPS), "--log-interval", "1",
            "--work-dir", work, "--seed", "0"], hooks=[hook])
        rows = [json.loads(line)
                for line in open(os.path.join(work, "metrics.jsonl"))]
        if done != VOTE_TRAIN_STEPS or not all(
                abs(r[k]) < float("inf") for r in rows
                for k in ("loss", "loss_vote", "grad_norm")):
            raise AssertionError(f"votenet {dataset} training: {rows}")
        times = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
        t = time.perf_counter()
        metrics = test_cli.main(common + ["--ckpt-dir",
                                          os.path.join(work, "ckpt")])
        eval_s = time.perf_counter() - t
        if len(metrics) != 3 * ncls or not all(
                0.0 <= v <= 100.0 for v in metrics.values()):
            raise AssertionError(f"votenet {dataset} evaluation: {metrics}")
        log(f"votenet {dataset} CLIs: {VOTE_TRAIN_STEPS} training steps, "
            f"ms/step {[round(x, 3) for x in times]} (the first builds the "
            f"model), losses {[round(r['loss'], 4) for r in rows]}; "
            f"tools/test.py over {VOTE_SCENES} scenes in {eval_s:.2f} s, "
            f"{len(metrics)} AP keys ({ncls} classes)")
    no_kernel_launches("votenet")
    log("votenet: window-attention launches 0")


def phase_nuscenes(dev, keep):
    """E. nuScenes frames (``write_nuscenes_frames``: key frame and a sweep
    of ``NUS_POINTS`` points inside SST's range, ``infos.pkl``):
    ``tools/train.py sst --dataset nuscenes`` for ``NUS_TRAIN_STEPS``
    float32 steps (12 forward and 12 backward window-attention launches
    per level per step) and ``tools/test.py sst --dataset nuscenes`` (12
    forward per level per frame, no backward); one Lyft sample of the same
    files with its sweep. Returns the launch counts (forward, backward)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    lo, hi = bench.sst_config().sst.pc_range[:3], \
        bench.sst_config().sst.pc_range[3:]
    root = os.path.join(keep, "nuscenes")
    info = write_nuscenes_frames(
        root, NUS_FRAMES, NUS_POINTS, num_sweeps=1,
        pc_range=tuple(x + 1 for x in lo) + tuple(x - 1 for x in hi))
    per_level = 2 * bench.sst_config().sst.num_blocks
    expect = {32: per_level, 144: per_level}
    work = os.path.join(root, "work")
    common = ["sst", "--dataset", "nuscenes", "--infos", info, "--data-root",
              root, "--device", "cuda"]
    stamps = []

    def hook(step, metrics):
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), dict(wa.LAUNCHES),
                       dict(wa.BWD_LAUNCHES)))

    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    t0 = time.perf_counter()
    done = train_cli.main(common + ["--total-steps", str(NUS_TRAIN_STEPS),
                                    "--log-interval", "1", "--work-dir",
                                    work, "--seed", "0"], hooks=[hook])
    fwd, bwd = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
    times = step_launches("nuscenes sst training", t0, stamps, expect)
    rows = [json.loads(line)
            for line in open(os.path.join(work, "metrics.jsonl"))]
    if done != NUS_TRAIN_STEPS or not all(
            abs(r[k]) < float("inf") for r in rows
            for k in ("loss", "loss_cls", "loss_bbox", "grad_norm")):
        raise AssertionError(f"nuscenes sst training: {rows}")
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    t = time.perf_counter()
    metrics = test_cli.main(common + ["--ckpt-dir",
                                      os.path.join(work, "ckpt")])
    eval_ms = (time.perf_counter() - t) * 1e3 / NUS_FRAMES
    efwd, ebwd = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
    if efwd != {T: per_level * NUS_FRAMES for T in expect} or any(ebwd) \
            or len(metrics) != 3 * 10:
        raise AssertionError(f"nuscenes sst evaluation: launches {efwd} "
                             f"{ebwd}, metrics {metrics}")
    s = LyftDataset(info, root, max_sweeps=1).build_sample(
        0, np.random.RandomState(0))
    pts = s["points"][s["points_mask"]]
    lags = sorted(set(np.round(pts[:, 4], 3)))
    if pts.shape[1] != 5 or len(pts) != min(2 * NUS_POINTS, 40000) or \
            lags != [0.0, 0.05]:
        raise AssertionError(f"lyft sample: {pts.shape}, lags {lags}")
    log(f"nuscenes sst (float32, {NUS_FRAMES} frames of {NUS_POINTS} "
        f"points and a sweep): {NUS_TRAIN_STEPS} training steps, ms/step "
        f"{[round(x, 3) for x in times]}, losses "
        f"{[round(r['loss'], 4) for r in rows]}, launches forward {fwd} "
        f"backward {bwd} ({per_level} per level per step each); "
        f"tools/test.py {eval_ms:.3f} ms per frame under the CLI, "
        f"launches {efwd} ({per_level} per level per frame), "
        f"{len(metrics)} AP keys; one Lyft sample with its sweep: "
        f"{len(pts)} points, time lags {lags}, "
        f"{int(s['gt_valid'].sum())} boxes; card {card_info()}")
    return ({T: fwd[T] + efwd[T] for T in expect}, bwd)


def run_ranks(argvs, what, timeout=RANK_WAIT, env=None):
    """Each argv in a subprocess that leads a process group of its own,
    from the repository's root, its output in a file; every group still
    running at ``timeout`` seconds is killed, which fails the phase with
    the outputs. Returns the outputs."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as logs:
        files = [open(os.path.join(logs, f"{i}.log"), "w+")
                 for i in range(len(argvs))]
        procs = [subprocess.Popen(argv, cwd=root, stdout=f,
                                  stderr=subprocess.STDOUT, text=True,
                                  env={**os.environ, **(env or {})},
                                  start_new_session=True)
                 for argv, f in zip(argvs, files)]
        deadline = time.monotonic() + timeout
        late = False
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                late = True
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
            f.close()
    for i, (p, out) in enumerate(zip(procs, outs)):
        log(f"{what}, process {i} (exit {p.returncode}):\n"
            + out.rstrip()[-4000:])
    if late:
        raise AssertionError(f"{what}: no end within {timeout} s")
    if any(p.returncode for p in procs):
        raise AssertionError(f"{what}: exit codes "
                             f"{[p.returncode for p in procs]}")
    return outs


def rank_argv(fn, *args):
    """``python -c "import chip_smoke; chip_smoke.fn(*args)"``."""
    return [sys.executable, "-c", f"import chip_smoke; chip_smoke.{fn}"
            f"({', '.join(repr(a) for a in args)})"]


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def occ_ddp_config():
    """Phase 38's config: ``OcOccNetConfig()`` in float32 (the training
    CLI's, packed layout, the config's dropout on) at lr ``OCC_STEP_LR``."""
    return dataclasses.replace(train_cli.ococc_train_config(dtype="float32"),
                               base_lr=OCC_STEP_LR)


def ococc_ddp_run(dev, batch, plain=False, mesh=None, opt="tree",
                  trace=False, **layout_kw):
    """``DDP_STEPS`` float32 steps of phase 38's config from the seeded init
    on ``batch`` (under the process group that is up, if any; ``mesh`` and
    ``layout_kw``: ``make_train_step``'s model-parallel layout; ``opt``:
    the optimizer layout, ``tree``, ``flat`` or ``stacked``): the first
    step's metrics and parameters gathered whole (``plain``: and clipped
    gradients), every step's metrics, this rank's parameter, gradient and
    AdamW moment bytes after it, every step's ms and the peak memory;
    ``trace``: then the kernels per step and per clip and update
    (``torch.profiler``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats(dev)
    state = create_train_state(occ_ddp_config(), 100, dev, 0,
                               flat_opt=opt == "flat",
                               stacked_opt=opt == "stacked")
    model, optimizer, schedule = state[:3]
    step_fn = make_train_step(
        model, optimizer, schedule, mesh=mesh, flat_opt=opt == "flat",
        stacked_spec=state[3] if opt == "stacked" else None, **layout_kw)
    layout = step_fn.layout

    def whole(name, t):
        d = layout.dims.get(name)
        t = t if d is None else cc.all_gather_cat(t, d, layout.group)
        return t.detach().cpu().clone()

    times, steps = [], []
    for k in range(DDP_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step_fn(k, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        steps.append({n: float(v) for n, v in metrics.items()})
        if k == 0:
            named = dict(model.named_parameters())
            moments = ([*optimizer.exp_avg.values(),
                        *optimizer.exp_avg_sq.values()]
                       if isinstance(optimizer, BufferAdamW) else
                       [v for st in optimizer.state.values()
                        for k2, v in st.items() if k2.startswith("exp_avg")])
            res = dict(metrics=steps[0],
                       params={n: whole(n, p) for n, p in named.items()},
                       lr=schedule(0), bytes=dict(
                           params=sum(p.numel() * 4 for p in named.values()),
                           grads=sum(p.grad.numel() * 4
                                     for p in named.values()),
                           moments=sum(v.numel() * 4 for v in moments)),
                       sharded=len(layout.dims), summed=len(layout.summed))
            if plain:
                res["grads"] = {n: p.grad.cpu()
                                for n, p in model.named_parameters()}
    res.update(ms=times, steps=steps,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    if trace:
        # the step, then its clip and update alone on the last gradients
        # (the parameters move on; nothing is compared after this)
        params = list(model.parameters())
        update = ((lambda: optimizer.step(schedule(DDP_STEPS)))
                  if isinstance(optimizer, BufferAdamW) else
                  (lambda: (clip_grad_global_norm_(
                      params, occ_ddp_config().grad_clip_norm),
                      optimizer.step())))
        res["launches"] = device_trace(
            lambda: step_fn(DDP_STEPS, batch), OPT_TRACE_CALLS)[0]
        res["update_launches"], res["update_ms"], _ = device_trace(
            update, OPT_TRACE_CALLS)
    if layout.fsdp:
        res["collectives"] = fsdp_collective_ms(model, layout)
    return res


def fsdp_collective_ms(model, layout, reps=3):
    """The FSDP step's collectives alone, median CUDA-synchronised ms of
    ``reps``: the one all-gather of the shards laid end to end, the one
    reduce-scatter of the whole gradients, the one all-reduce of the
    replicated gradients; with each one's MB per rank."""
    named = dict(model.named_parameters())
    flat = torch.cat([named[n].detach().reshape(-1) for n in layout.dims])
    rest = torch.cat([p.detach().reshape(-1) for n, p in named.items()
                      if n not in layout.dims])
    whole = flat.new_zeros(layout.size, flat.numel())
    ops = {"all_gather": lambda: cc.all_gather_cat(flat[None], 0,
                                                   layout.group),
           "reduce_scatter": lambda: cc.reduce_scatter_dim(whole, 0,
                                                           layout.group),
           "all_reduce": lambda: cc.all_reduce_(rest.clone(), layout.group)}
    out = {}
    for name, fn in ops.items():
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(times)
    out["mb"] = dict(all_gather=flat.numel() * 4 * layout.size / 1e6,
                     reduce_scatter=whole.numel() * 4 / 1e6,
                     all_reduce=rest.numel() * 4 / 1e6)
    return out


def ococc_rank(rank, world, port, out, opt="tree"):
    """One rank of phase 38 (``opt``: the optimizer layout, phase 47's
    ``flat``) in a process of its own: ``world`` 1, DDP in an NCCL group of
    one rank on the global batch; else rank ``rank`` of ``world`` over gloo
    on ``cuda:0``, on its slice."""
    import torch.distributed as dist
    from objectcentricocccompletion_torch.parallel import multihost
    batch = synthetic_batch(occ_ddp_config(), batch_size=DDP_OCC_BATCH,
                            seed=0)
    if world == 1:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{port}", world_size=1, rank=0)
        dev = torch.device("cuda")
    else:
        dev = multihost.initialize(f"127.0.0.1:{port}", world, rank, "gloo",
                                   "cuda")
        per = DDP_OCC_BATCH // world
        batch = TrackletBatch(*(x[rank * per:(rank + 1) * per]
                                for x in batch))
    res = ococc_ddp_run(dev, batch, opt=opt)
    multihost.shutdown()
    torch.save(res, os.path.join(out, f"ococc_{opt}_{world}_{rank}.pt"))


def compare_occ_steps(what, got, ref):
    """Phase 8's float32-step bars (``phase_ococc_fp32_step``) between two
    card runs: the loss dict, ``grad_norm``, every parameter after the
    update (2 lr apart where the reference's gradient lies within the
    gradient bar of 0, else 1e-3 lr, plus rounding). Returns whether the
    parameters are bit-equal."""
    for k, v in ref["metrics"].items():
        err = abs(got["metrics"][k] - v)
        tol = (OCC_STEP_GRAD_NORM_RTOL * v if k == "grad_norm"
               else OCC_STEP_LOSS_ATOL)
        if not err <= tol:
            raise AssertionError(f"{what}: {k} {got['metrics'][k]} vs {v}")
    lr = ref["lr"]
    near = far = 0.0
    for n, p in ref["params"].items():
        diff = (got["params"][n] - p).abs()
        small = ref["grads"][n].abs() < OCC_STEP_GRAD_ATOL
        near = max(near, float(torch.where(small, diff, 0).max()))
        far = max(far, float(torch.where(small, 0, diff).max()))
    equal = all(torch.equal(got["params"][n], p)
                for n, p in ref["params"].items())
    log(f"{what}: losses {[round(got['metrics'][k], 6) for k in OCC_LOSSES]}"
        f" vs {[round(ref['metrics'][k], 6) for k in OCC_LOSSES]}, "
        f"grad_norm {got['metrics']['grad_norm']:.6f} vs "
        f"{ref['metrics']['grad_norm']:.6f}; parameters after the update at "
        f"lr {lr:.1e}: {near:.3e} where |g| < {OCC_STEP_GRAD_ATOL} "
        f"(tolerance {OCC_STEP_ROUNDING + 2 * lr:.3e}), {far:.3e} elsewhere "
        f"(tolerance {OCC_STEP_ROUNDING + 1e-3 * lr:.3e}); bit-equal: "
        f"{equal}")
    if not (near <= OCC_STEP_ROUNDING + 2 * lr
            and far <= OCC_STEP_ROUNDING + 1e-3 * lr):
        raise AssertionError(f"{what}: parameters {near}, {far}")
    return equal


def phase_ococc_ddp(dev):
    """38. Data-parallel OcOccNet training, float32 (TF32 off, dropout on,
    lr ``OCC_STEP_LR``) at the full width of ``OcOccNetConfig()``,
    ``DDP_STEPS`` steps from the same init on ``synthetic_batch`` of
    ``DDP_OCC_BATCH`` tracklets: the plain step in this process; (a) DDP
    in an NCCL group of one rank against it, (b) two ranks over gloo on
    ``cuda:0`` (half the batch each) against it, their parameters
    bit-equal. Each run of (a) and (b) a process group of its own, killed
    at ``RANK_WAIT`` s."""
    torch.cuda.empty_cache()
    plain = ococc_ddp_run(dev, synthetic_batch(
        occ_ddp_config(), batch_size=DDP_OCC_BATCH, seed=0), plain=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        run_ranks([rank_argv("ococc_rank", 0, 1, free_port(), out)],
                  "ococcnet ddp nccl x1")
        port = free_port()
        run_ranks([rank_argv("ococc_rank", r, 2, port, out) for r in (0, 1)],
                  "ococcnet ddp gloo x2")
        nccl = torch.load(os.path.join(out, "ococc_tree_1_0.pt"),
                          weights_only=False)
        ranks = [torch.load(os.path.join(out, f"ococc_tree_2_{r}.pt"),
                            weights_only=False) for r in (0, 1)]
    compare_occ_steps("ococcnet ddp (a) nccl x1 vs plain", nccl, plain)
    compare_occ_steps("ococcnet ddp (b) gloo x2 vs plain", ranks[0], plain)
    same = [n for n, p in ranks[0]["params"].items()
            if torch.equal(p, ranks[1]["params"][n])]
    if len(same) != len(ranks[0]["params"]):
        raise AssertionError(f"ococcnet ddp: the ranks' parameters differ "
                             f"in {len(ranks[0]['params']) - len(same)} "
                             f"tensors")
    card = card_info()
    for name, res, b in (("plain", plain, DDP_OCC_BATCH),
                         ("nccl x1", nccl, DDP_OCC_BATCH),
                         ("gloo rank 0 of 2", ranks[0], DDP_OCC_BATCH // 2),
                         ("gloo rank 1 of 2", ranks[1], DDP_OCC_BATCH // 2)):
        timed = res["ms"][1:]
        log(f"ococcnet ddp {name}: batch {b} per process, "
            f"{statistics.median(timed):.3f} ms/step (median of steps 2-"
            f"{DDP_STEPS}; all {[round(x, 3) for x in res['ms']]}), peak "
            f"memory {res['peak_gib']:.3f} GiB; one card: the collectives' "
            f"overhead, not scaling; card {card}")
    log(f"ococcnet ddp: the two ranks' {len(same)} parameter tensors "
        f"bit-equal")
    return plain


def sst_ddp_frames():
    """Phase 39's global batch: ``2 * DDP_SST_FRAMES`` dense synthetic
    frames (seeds 0, 1, ...) at the full width of the training CLI's
    float32 SST."""
    cfg = train_cli.sst_train_config()
    frames = [bench.train_batch(cfg, "cpu", 150000, seed=s)
              for s in range(2 * DDP_SST_FRAMES)]
    return FrameBatch(*(torch.cat(parts) for parts in zip(*frames)))


def sst_ddp_run(dev, batch):
    """``DDP_STEPS`` float32 steps (TF32 off) of the full-width SST from the
    seeded init on ``batch`` (under the process group that is up, if any):
    the first step's metrics and clipped gradients, every step's ms, the
    window-attention launches and the peak memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats(dev)
    model = SSTDetector(train_cli.sst_train_config(), dev,
                        torch.Generator().manual_seed(0))
    optimizer, schedule = make_optimizer(model.named_parameters(), 1e-5, 100)
    step_fn = make_detector_train_step(model, optimizer, schedule)
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    times = []
    for k in range(DDP_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step_fn(k, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if k == 0:
            res = dict(metrics={n: float(v) for n, v in metrics.items()},
                       grads={n: p.grad.cpu()
                              for n, p in model.named_parameters()
                              if p.grad is not None})
    res.update(ms=times, fwd=dict(wa.LAUNCHES), bwd=dict(wa.BWD_LAUNCHES),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    return res


def sst_rank(rank, world, port, out):
    """Rank ``rank`` of ``world`` of phase 39, over gloo on ``cuda:0``, on
    its ``DDP_SST_FRAMES`` frames of the global batch."""
    from objectcentricocccompletion_torch.parallel import multihost
    dev = multihost.initialize(f"127.0.0.1:{port}", world, rank, "gloo",
                               "cuda")
    lo = rank * DDP_SST_FRAMES
    batch = FrameBatch(*(x[lo:lo + DDP_SST_FRAMES]
                         for x in sst_ddp_frames()))
    res = sst_ddp_run(dev, batch)
    multihost.shutdown()
    torch.save(res, os.path.join(out, f"sst_{rank}.pt"))


def phase_sst_ddp(dev):
    """39. Data-parallel SST training, float32 (the detector's default;
    TF32 off) at the full width of ``SSTDetectorConfig()``: two ranks over
    gloo on ``cuda:0``, ``DDP_SST_FRAMES`` dense frames each, against this
    process on all their frames, ``DDP_STEPS`` steps each: the first
    step's clipped gradients at ``phase_fp32_grad_check``'s bars; each
    rank launches 12 forward and 12 backward window-attention kernels per
    level per frame and step. Returns the launches (forward, backward) of
    the three runs summed."""
    torch.cuda.empty_cache()
    one = sst_ddp_run(dev, sst_ddp_frames())
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        port = free_port()
        run_ranks([rank_argv("sst_rank", r, 2, port, out) for r in (0, 1)],
                  "sst ddp gloo x2")
        ranks = [torch.load(os.path.join(out, f"sst_{r}.pt"),
                            weights_only=False) for r in (0, 1)]
    per_level = 2 * train_cli.sst_train_config().sst.num_blocks
    expect = {T: per_level * DDP_STEPS * DDP_SST_FRAMES
              for _, T in ATTN_SHAPES}
    scale = max(float(g.abs().max()) for g in one["grads"].values())
    if one["fwd"] != {T: 2 * n for T, n in expect.items()} or \
            one["bwd"] != one["fwd"]:
        raise AssertionError(f"sst one process: launches forward "
                             f"{one['fwd']} backward {one['bwd']}")
    fwd, bwd = collections.Counter(one["fwd"]), collections.Counter(
        one["bwd"])
    card = card_info()
    for r, res in enumerate(ranks):
        if res["fwd"] != expect or res["bwd"] != expect:
            raise AssertionError(f"sst ddp rank {r}: launches forward "
                                 f"{res['fwd']} backward {res['bwd']}, "
                                 f"expected {expect} each")
        fwd.update(res["fwd"])
        bwd.update(res["bwd"])
        worst = (0.0, "")
        for n, ref in one["grads"].items():
            err = float((res["grads"][n] - ref).abs().max())
            tol = GRAD_RTOL * float(ref.abs().max()) + GRAD_FLOOR * scale
            if not err <= tol:
                raise AssertionError(f"sst ddp rank {r} gradient {n}: {err}"
                                     f" > {tol}")
            worst = max(worst, (err / tol, n))
        log(f"sst ddp rank {r}: loss {res['metrics']['loss']:.6f} vs "
            f"{one['metrics']['loss']:.6f} (one process), grad_norm "
            f"{res['metrics']['grad_norm']:.6f} vs "
            f"{one['metrics']['grad_norm']:.6f}; {len(one['grads'])} clipped "
            f"gradients within the bar, worst {worst[1]} at {worst[0]:.3f} "
            f"of it; launches over {DDP_STEPS} steps forward {res['fwd']} "
            f"backward {res['bwd']}")
    for name, res, b in (("one process", one, 2 * DDP_SST_FRAMES),
                         ("gloo rank 0 of 2", ranks[0], DDP_SST_FRAMES),
                         ("gloo rank 1 of 2", ranks[1], DDP_SST_FRAMES)):
        log(f"sst ddp {name}: {b} frame(s) per process, "
            f"{statistics.median(res['ms'][1:]):.3f} ms/step (median of "
            f"steps 2-{DDP_STEPS}; all {[round(x, 3) for x in res['ms']]}), "
            f"peak memory {res['peak_gib']:.3f} GiB; one card: the "
            f"collectives' overhead, not scaling; card {card}")
    return dict(fwd), dict(bwd)


def eval_run(dev, data, ckpt, out):
    """``Evaluator.run`` (float32, TF32 off, the dense eval layout, the
    baseline, the Waymo metrics on rank 0; deterministic kernels) of the
    checkpoint under ``ckpt`` on the tracklets under ``data``, into
    ``out``, under the process group that is up, if any: the metrics and
    the seconds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(train_cli.ococc_train_config(),
                              packed_point_budget=None)
    ds = TrackletDataset(cfg=cfg, training=False, min_tracklet_length=1,
                         **dataset_paths(data))
    model = OcOccNetWithLoss(cfg, dev)
    CheckpointManager(ckpt).restore(model)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t = time.perf_counter()
        metrics = evaluator.Evaluator(model, ds, cfg, device=dev).run(
            out, eval_occ_baseline=True)
        seconds = time.perf_counter() - t
    finally:
        torch.use_deterministic_algorithms(False)
    return dict(metrics=metrics, seconds=seconds)


def eval_rank(rank, world, port, data, ckpt, out):
    """Rank ``rank`` of ``world`` of phase 40, over gloo on ``cuda:0``."""
    from objectcentricocccompletion_torch.parallel import multihost
    dev = multihost.initialize(f"127.0.0.1:{port}", world, rank, "gloo",
                               "cuda")
    res = eval_run(dev, data, ckpt, os.path.join(out, "ddp"))
    multihost.shutdown()
    torch.save(res, os.path.join(out, f"eval_{rank}.pt"))


def phase_sharded_eval(dev, occ_dir):
    """40. Sharded evaluation: ``Evaluator.run`` of phase 8's checkpoint
    on its tracklets, two ranks over gloo on ``cuda:0`` (tracklets
    round-robin) against this process: rank 0's ``results.bin`` is the
    shards' bytes in rank order, its objects equal the one process's as a
    multiset, and every metric (occupancy, baseline, Waymo) is equal."""
    torch.cuda.empty_cache()
    data = os.path.join(occ_dir, "data")
    ckpt = os.path.join(occ_dir, "work", "ckpt")
    with tempfile.TemporaryDirectory() as out:
        one = eval_run(dev, data, ckpt, os.path.join(out, "single"))
        port = free_port()
        run_ranks([rank_argv("eval_rank", r, 2, port, data, ckpt, out)
                   for r in (0, 1)], "evaluation gloo x2")
        ranks = [torch.load(os.path.join(out, f"eval_{r}.pt"),
                            weights_only=False) for r in (0, 1)]
        ddp_dir = os.path.join(out, "ddp")
        shards = [open(os.path.join(ddp_dir, f"results.shard{r}.bin"),
                       "rb").read() for r in (0, 1)]
        merged = open(os.path.join(ddp_dir, "results.bin"), "rb").read()
        objects = [sorted(repr(sorted(o.items())) for o in read_bin(p))
                   for p in (os.path.join(ddp_dir, "results.bin"),
                             os.path.join(out, "single", "results.bin"))]
    if merged != shards[0] + shards[1] or not all(shards):
        raise AssertionError("sharded evaluation: results.bin is not the "
                             "shards' bytes in rank order")
    if objects[0] != objects[1]:
        raise AssertionError(f"sharded evaluation: {len(objects[0])} objects"
                             f" against {len(objects[1])}, not the same "
                             f"multiset")
    ref = {k: v for k, v in one["metrics"].items() if k != "results_bin"}
    waymo = [k for k in ref if not k.startswith(("occ", "num_"))]

    def same(a, b):
        return a == b or (a != a and b != b)       # NaN equals NaN here

    for r, res in enumerate(ranks):
        got = res["metrics"]
        differ = [k for k, v in ref.items() if (r == 0 or k not in waymo)
                  and not (k in got and same(got[k], v))]
        if differ:
            raise AssertionError(f"sharded evaluation rank {r}: metrics "
                                 f"differ {differ}")
    log(f"sharded evaluation: {ref['num_tracklets']} tracklets, "
        f"{len(objects[0])} objects equal as a multiset, results.bin = "
        f"shard0 ({len(shards[0])} B) + shard1 ({len(shards[1])} B); "
        f"{len(ref)} metrics equal (occ/overall_iou "
        f"{ref['occ/overall_iou']:.6f}, {len(waymo)} Waymo ones on rank 0); "
        f"Evaluator.run {one['seconds']:.2f} s in one process, "
        f"{ranks[0]['seconds']:.2f} / {ranks[1]['seconds']:.2f} s on the "
        f"ranks; one card: the collectives' overhead, not scaling; card "
        f"{card_info()}")


# 41-44: the model-parallel layouts, each rank a process of its own
# (tag, mesh shape, make_train_step options) of phases 41-43
MP_TP = ("tp", (1, 2), {})
MP_SP = ("tp_sp", (1, 2), dict(sequence_parallel=True))
MP_FSDP = ("fsdp", (2, 1), dict(fsdp=True))
# phase 44's CLI steps
MP_CLI_STEPS = 3


def mp_rank(rank, world, port, out, layouts):
    """Ranks of phases 41-43: ``world`` 1, an NCCL group of one rank; else
    rank ``rank`` of ``world`` over gloo on ``cuda:0``. For each (tag, mesh
    shape, options) of ``layouts`` in turn, phase 38's steps
    (``ococc_ddp_run``) on this data rank's slice of phase 38's batch;
    writes ``out/mp_{tag}_{rank}.pt`` with the window-attention launches."""
    import torch.distributed as dist
    from objectcentricocccompletion_torch.parallel import multihost
    if world == 1:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{port}", world_size=1, rank=0)
        dev = torch.device("cuda")
    else:
        dev = multihost.initialize(f"127.0.0.1:{port}", world, rank, "gloo",
                                   "cuda")
    batch = synthetic_batch(occ_ddp_config(), batch_size=DDP_OCC_BATCH,
                            seed=0)
    for tag, shape, kw in layouts:
        mesh = make_mesh_2d(*shape, device_type="cuda")
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        res = ococc_ddp_run(dev, shard_batch(batch, mesh), mesh=mesh, **kw)
        res["launches"] = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
        torch.save(res, os.path.join(out, f"mp_{tag}_{rank}.pt"))
        torch.cuda.empty_cache()
    multihost.shutdown()


def mp_line(what, res, batch):
    """One rank's step time, peak and bytes."""
    b = res["bytes"]
    log(f"{what}: batch {batch} per data rank, "
        f"{statistics.median(res['ms'][1:]):.3f} ms/step (median of steps "
        f"2-{DDP_STEPS}; all {[round(x, 3) for x in res['ms']]}), peak "
        f"memory {res['peak_gib']:.3f} GiB; parameters {b['params'] / 1e6:.1f}"
        f" MB, gradients {b['grads'] / 1e6:.1f} MB, AdamW moments "
        f"{b['moments'] / 1e6:.1f} MB ({sum(b.values()) / 1e6:.1f} MB in "
        f"all); {res['sharded']} tensors sharded, {res['summed']} summed "
        f"over the model group; card {card_info()}")


def mp_ranks(tag, world, out):
    ranks = [torch.load(os.path.join(out, f"mp_{tag}_{r}.pt"),
                        weights_only=False) for r in range(world)]
    for r, res in enumerate(ranks):
        if any(res["launches"]):
            raise AssertionError(f"model parallelism {tag} rank {r}: "
                                 f"window-attention kernels launched "
                                 f"{res['launches']}; this path has none")
    return ranks


def ranks_bit_equal(what, ranks):
    for res in ranks[1:]:
        differ = [n for n, p in ranks[0]["params"].items()
                  if not torch.equal(p, res["params"][n])]
        if differ:
            raise AssertionError(f"{what}: the ranks' whole parameters "
                                 f"differ in {len(differ)} tensors")


def phase_model_parallel(dev, plain):
    """41-43. Model-parallel OcOccNet training, phase 38's float32 steps
    (``OcOccNetConfig()``, packed, dropout on, global batch
    ``DDP_OCC_BATCH``) against its plain step ``plain`` at its bars, each
    run a process group of its own killed at ``RANK_WAIT`` s: 41 TP, (a)
    an NCCL group of one rank on a (1, 1) mesh, (b) two gloo ranks on
    ``cuda:0``, mesh (1, 2); 42 FSDP, two gloo ranks, mesh (2, 1), with
    its collectives timed alone; 43 TP with sequence parallelism, mesh (1,
    2), in 41 (b)'s processes. Per rank: ms per step, peak, parameter,
    gradient and moment bytes. 0 window-attention launches."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        t = time.perf_counter()
        run_ranks([rank_argv("mp_rank", 0, 1, free_port(), out,
                             [("nccl", (1, 1), {})])], "tp nccl x1")
        t_a = time.perf_counter() - t
        t = time.perf_counter()
        port = free_port()
        run_ranks([rank_argv("mp_rank", r, 2, port, out, [MP_TP, MP_SP])
                   for r in (0, 1)], "tp and tp + sp gloo x2")
        t_b = time.perf_counter() - t
        t = time.perf_counter()
        port = free_port()
        run_ranks([rank_argv("mp_rank", r, 2, port, out, [MP_FSDP])
                   for r in (0, 1)], "fsdp gloo x2")
        t_f = time.perf_counter() - t
        nccl = mp_ranks("nccl", 1, out)[0]
        tp, tp_sp, fsdp = (mp_ranks(tag, 2, out)
                           for tag in ("tp", "tp_sp", "fsdp"))
    card = card_info()
    equal = compare_occ_steps("41 (a) tp nccl x1, mesh (1, 1), vs plain",
                              nccl, plain)
    mp_line("41 (a) tp nccl x1", nccl, DDP_OCC_BATCH)
    for tag, ranks, batch in (("41 (b) tp gloo x2, mesh (1, 2)", tp,
                               DDP_OCC_BATCH),
                              ("42 fsdp gloo x2, mesh (2, 1)", fsdp,
                               DDP_OCC_BATCH // 2),
                              ("43 tp + sp gloo x2, mesh (1, 2)", tp_sp,
                               DDP_OCC_BATCH)):
        compare_occ_steps(f"{tag} vs plain", ranks[0], plain)
        ranks_bit_equal(tag, ranks)
        for r, res in enumerate(ranks):
            mp_line(f"{tag} rank {r}", res, batch)
    for r, res in enumerate(fsdp):
        c = res["collectives"]
        log(f"42 fsdp rank {r}: the step's collectives alone, "
            + ", ".join(f"{k} {c[k]:.3f} ms ({c['mb'][k]:.1f} MB)"
                        for k in ("all_gather", "reduce_scatter",
                                  "all_reduce"))
            + f"; card {card}")
    log(f"41-43: plain (phase 38) {statistics.median(plain['ms'][1:]):.3f} "
        f"ms/step at {plain['peak_gib']:.3f} GiB; 43's peak per rank "
        f"{tp_sp[0]['peak_gib']:.3f} / {tp_sp[1]['peak_gib']:.3f} GiB "
        f"against it; 41 (a) bit-equal to plain: {equal}; processes "
        f"{t_a:.1f} s (41 a), {t_b:.1f} s (41 b + 43), {t_f:.1f} s (42); "
        f"0 window-attention launches; card {card}")


def mp_cli_rank(argv, out):
    """One process of phase 44: ``tools/train.py`` on ``argv``, then the
    window-attention launches to ``out``."""
    train_cli.main(argv)
    torch.save((dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)), out)


def mp_cli_compare(what, work, one, cfg, dev):
    """Phase 44's bars between a model-parallel CLI run's ``work`` and the
    one-process run's ``one``: every logged step's losses and
    ``grad_norm`` at phase 38's bars, the final checkpoint's parameters
    within 2 lr per step (AdamW's step, whose sign may differ where a
    gradient is float noise around 0) plus rounding; the checkpoint
    restored in one process names the file's tree (``tree_hash``)."""
    rows = [[json.loads(line) for line in open(os.path.join(d,
                                                            "metrics.jsonl"))]
            for d in (work, one)]
    if not ([r["step"] for r in rows[0]] == [r["step"] for r in rows[1]]
            == list(range(1, MP_CLI_STEPS + 1))):
        raise AssertionError(f"{what}: logged steps {rows}")
    for got, ref in zip(*rows):
        for k, v in ref.items():
            if not k.startswith(("loss", "grad_norm")):
                continue
            tol = (OCC_STEP_GRAD_NORM_RTOL * v if k == "grad_norm"
                   else OCC_STEP_LOSS_ATOL)
            if not abs(got[k] - v) <= tol:
                raise AssertionError(f"{what} step {ref['step']}: {k} "
                                     f"{got[k]} vs {v}")
    path = os.path.join(work, "ckpt", f"step_{MP_CLI_STEPS}.pt")
    mp, ref = (torch.load(p, map_location="cpu", weights_only=True)
               for p in (path, os.path.join(one, "ckpt",
                                            f"step_{MP_CLI_STEPS}.pt")))
    bar = 2 * sum(r["lr"] for r in rows[1]) + OCC_STEP_ROUNDING
    worst = max(float((mp["model"][n] - p).abs().max())
                for n, p in ref["model"].items())
    if set(mp["model"]) != set(ref["model"]) or not worst <= bar:
        raise AssertionError(f"{what}: checkpoint parameters {worst} (bar "
                             f"{bar})")
    model, optimizer, _ = create_train_state(cfg, MP_CLI_STEPS, dev, 0)
    step = CheckpointManager(os.path.join(work, "ckpt")).restore(model,
                                                                 optimizer)
    moments = [st["exp_avg"].shape == p.shape for p, st in
               optimizer.state.items()]
    names = [surgery.tree_hash(sd) for sd in (model.state_dict(),
                                              mp["model"], ref["model"])]
    if step != MP_CLI_STEPS or not all(moments) or len(moments) != \
            len(list(model.parameters())) or names[0] != names[1]:
        raise AssertionError(f"{what}: restored step {step}, moments whole "
                             f"{sum(moments)} of {len(moments)}, names "
                             f"{names}")
    log(f"{what}: {MP_CLI_STEPS} steps, losses "
        f"{[round(r['loss'], 6) for r in rows[0]]} vs "
        f"{[round(r['loss'], 6) for r in rows[1]]}, grad_norm "
        f"{[round(r['grad_norm'], 6) for r in rows[0]]} vs "
        f"{[round(r['grad_norm'], 6) for r in rows[1]]}; checkpoint "
        f"parameters {worst:.3e} from one process's (bar {bar:.3e}); "
        f"restored in one process at step {step}, whole moments, "
        f"tree_hash {names[0][:8]} = the file's; one process's "
        f"{names[2][:8]} (equal: {names[0] == names[2]}); "
        f"{rows[0][-1]['tracklets_per_sec']:.2f} vs "
        f"{rows[1][-1]['tracklets_per_sec']:.2f} tracklets/s at the last "
        f"step; card {card_info()}")


def phase_mp_cli(dev, occ_dir):
    """44. ``tools/train.py ococcnet --tp 2 --fsdp --sequence-parallel`` in
    four gloo processes on ``cuda:0`` (mesh (2, 2)) and ``ctrl --tp 2`` in
    two (mesh (1, 2)), ``MP_CLI_STEPS`` float32 steps on phase 8's
    tracklets, each against ``train`` in this process at the global batch
    (``mp_cli_compare``); 0 window-attention launches."""
    torch.cuda.empty_cache()
    data = os.path.join(occ_dir, "data")
    flags = ["--proposals", os.path.join(data, "proposals.pkl"),
             "--gt-candidates", os.path.join(data, "gt_candidates.pkl"),
             "--poses", os.path.join(data, "poses.pkl"), "--occ-root",
             os.path.join(data, "occ_gt"), "--total-steps",
             str(MP_CLI_STEPS), "--log-interval", "1", "--device", "cuda",
             "--seed", "0", "--dist-backend", "gloo"]
    paths = dataset_paths(data)
    with tempfile.TemporaryDirectory() as out:
        for model, world, extra in (
                ("ococcnet", 4, ["--tp", "2", "--fsdp",
                                 "--sequence-parallel"]),
                ("ctrl", 2, ["--tp", "2"])):
            work = os.path.join(out, model)
            port = free_port()
            t = time.perf_counter()
            run_ranks([rank_argv(
                "mp_cli_rank", [model, *flags, "--work-dir", work,
                                "--coordinator", f"127.0.0.1:{port}",
                                "--num-processes", str(world),
                                "--process-id", str(r), *extra],
                os.path.join(out, f"{model}_{r}.pt")) for r in range(world)],
                f"{model} cli {' '.join(extra)} x{world}")
            seconds = time.perf_counter() - t
            for r in range(world):
                launched = torch.load(os.path.join(out, f"{model}_{r}.pt"))
                if any(launched):
                    raise AssertionError(f"{model} cli rank {r}: "
                                         f"window-attention kernels "
                                         f"launched {launched}")
            cfg = train_cli.ococc_train_config(model)
            data_axis = world // 2
            one = os.path.join(out, f"{model}_one")
            ds = TrackletDataset(cfg=cfg, class_names=cfg.class_names,
                                 **paths)
            wa.LAUNCHES.clear()
            wa.BWD_LAUNCHES.clear()
            train_tracklets(dataclasses.replace(
                cfg, batch_size=data_axis * cfg.batch_size), ds, one,
                total_steps=MP_CLI_STEPS, log_interval=1, device=dev)
            no_kernel_launches(f"{model} cli one process")
            mp_cli_compare(f"44 {model} cli {' '.join(extra)} x{world} "
                           f"({seconds:.1f} s) vs one process at batch "
                           f"{data_axis * cfg.batch_size}", work, one, cfg,
                           dev)


def cp_near_frame(dev):
    """``CP_NEAR``'s frame: within every budget of both encoder layouts."""
    n, seed, scale = CP_NEAR
    pts, msk = bench.frame_tensors(CenterPointConfig(), dev, n, seed)
    pts[:, :2] *= scale
    return pts, msk


def within_budgets(rows):
    return all(r["occupied"] <= r["budget"] for r in rows)


def phase_cp_column(dev):
    """45. CenterPoint with ``encoder_layout="column"`` at the full width of
    ``CenterPointConfig()`` on phase 12's dense and sparse frames and the
    near frame, float32 and the config's default (bf16 activations, remat
    on): the occupied columns per stage against their budgets, ms per frame
    of each layout and dtype and the peak memory; float32 with TF32 off:
    the column head maps against the gather layout's on the same weights on
    every frame within every budget, and the dense frame on the card
    against the port on the CPU, at phase 13's bar. 0 window-attention
    launches."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CenterPointConfig()
    frames = {"dense": bench.frame_tensors(cfg, dev, 150000, seed=0),
              "sparse": bench.frame_tensors(cfg, dev, 20000, seed=1),
              "near": cp_near_frame(dev)}
    card = card_info()
    fits = {}
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    for layout, dtype in (("gather", None), ("column", "float32"),
                          ("column", None)):
        model = bench.build_centerpoint(dev, 0, layout, dtype)
        predict = make_predict_fn(model, "centerpoint")
        what = f"centerpoint {layout} ({dtype or cfg.encoder_dtype} " \
               f"activations)" if layout == "column" else \
               "centerpoint gather (float32)"
        for name, (pts, msk) in frames.items():
            rows = model.voxel_occupancy(pts, msk)
            fits[name] = fits.get(name, True) and within_budgets(rows)
            predict(pts, msk)                                  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            out = predict(pts, msk)
            shapes = [tuple(x.shape) for x in out]
            if shapes != [(500, 9), (500,), (500,), (500,)] or not all(
                    torch.isfinite(x.float()).all() for x in out):
                raise AssertionError(f"{what} predict: shapes {shapes} or "
                                     f"values not finite")
            times = bench.time_frames(predict, pts, msk, CP_COLUMN_TIMED,
                                      warmup=0)
            log(f"{what} frame {name}: {statistics.median(times):.3f} "
                f"ms/frame (median of {CP_COLUMN_TIMED}: "
                f"{[round(t, 3) for t in times]}), peak memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB; "
                f"occupied/budget {voxel_line(rows)}; card {card}")
        del model, predict
        torch.cuda.empty_cache()
    no_kernel_launches("centerpoint column inference")
    torch.backends.cudnn.allow_tf32 = False
    gather = bench.build_centerpoint(dev, 0)
    column = bench.build_centerpoint(dev, 0, "column", "float32")
    cpu = bench.build_centerpoint("cpu", 0, "column", "float32")
    same = all(torch.equal(p, q) for p, q in zip(
        gather.state_dict().values(), column.state_dict().values()))
    if not same or gather.state_dict().keys() != column.state_dict().keys():
        raise AssertionError("centerpoint: the two layouts' seeded weights "
                             "differ")
    compared = [n for n, ok in fits.items() if ok]
    log(f"centerpoint column vs gather (float32, TF32 off, the same "
        f"weights): frames within every budget {compared}, overflowing "
        f"{[n for n, ok in fits.items() if not ok]} (not compared)")
    if "near" not in compared:
        raise AssertionError("centerpoint: the near frame overflows a "
                             "budget")
    with torch.inference_mode():
        for name in compared:
            pts, msk = frames[name]
            compare_outputs(f"centerpoint frame {name} column vs gather, "
                            f"card", column(pts, msk),
                            {k: v.cpu() for k, v in gather(pts, msk).items()},
                            CP_HEADS)
        pts, msk = frames["dense"]
        compare_outputs("centerpoint column frame dense, card vs CPU",
                        column(pts, msk), cpu(pts.cpu(), msk.cpu()),
                        CP_HEADS)
    no_kernel_launches("centerpoint column card vs CPU")


def phase_cp_column_training(dev, frames_dir, work, gather_step):
    """46. Column-layout CenterPoint training through
    ``training/detector_trainer.py::train_detector`` on phase 5's frames,
    ``CP_COLUMN_STEPS`` steps in bf16 (the config's default) and float32
    (the CLI's TF32 settings): finite losses, ms/step and the peak memory
    beside phase 14's gather numbers; then one float32 step card against
    CPU at phase 15's bars."""
    infos = os.path.join(frames_dir, "infos.pkl")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    for dtype in ("bfloat16", "float32"):
        stamps = []

        def hook(step, metrics):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        model = bench.build_centerpoint(dev, 0, "column", dtype).train()
        ds = train_cli.frame_dataset("waymo", infos, frames_dir)
        out = os.path.join(work, f"column_{dtype}")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        done = train_detector(model, ds, out, CP_COLUMN_STEPS,
                              log_interval=1, device=dev, hooks=[hook])
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        rows = [json.loads(line) for line in
                open(os.path.join(out, "metrics.jsonl"))]
        keys = ("loss", "loss_heatmap", "loss_bbox", "grad_norm")
        if done != CP_COLUMN_STEPS or len(rows) != CP_COLUMN_STEPS or not all(
                abs(r[k]) < float("inf") for r in rows for k in keys):
            raise AssertionError(f"centerpoint column {dtype} training: "
                                 f"{done} steps, metrics {rows}")
        times = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
        timed = times[TRAIN_TIMED_FROM - 1:]
        log(f"centerpoint column training ({dtype} activations): "
            f"{CP_COLUMN_STEPS} steps, losses "
            f"{[round(r['loss'], 4) for r in rows]}, "
            f"{statistics.median(timed):.3f} ms/step (median of steps "
            f"{TRAIN_TIMED_FROM}-{CP_COLUMN_STEPS}; all "
            f"{[round(x, 3) for x in times]}), peak memory {peak:.3f} GiB; "
            f"phase 14's gather layout (float32, the CLI): "
            f"{gather_step[0]:.3f} ms/step, {gather_step[1]:.3f} GiB; "
            f"card {card}")
        del model
        torch.cuda.empty_cache()
    no_kernel_launches("centerpoint column training")
    phase_cp_fp32_step(dev, "column")


def phase_opt_layouts(dev, plain):
    """47. OcOccNet's float32 step at phase 38's config and batch with the
    flat and the stacked optimizer layouts: ``DDP_STEPS`` steps each, every
    step's losses and ``grad_norm`` and the parameters after the first at
    phase 38's bars of its plain (tree) step; ms per step, and per layout
    the kernels per step and per clip and update (``torch.profiler``,
    the tree's beside them). 0 window-attention launches."""
    batch = synthetic_batch(occ_ddp_config(), batch_size=DDP_OCC_BATCH,
                            seed=0)
    card = card_info()
    wa.LAUNCHES.clear()
    wa.BWD_LAUNCHES.clear()
    runs = {}
    for opt in ("tree", "flat", "stacked"):
        torch.cuda.empty_cache()
        runs[opt] = res = ococc_ddp_run(dev, batch, opt=opt, trace=True)
        compare_occ_steps(f"ococcnet {opt} optimizer vs phase 38's plain "
                          f"step", res, plain)
        check_occ_step_metrics(f"ococcnet {opt} optimizer", res, plain)
        log(f"ococcnet {opt} optimizer: losses "
            f"{[round(r['loss'], 6) for r in res['steps']]} vs plain "
            f"{[round(r['loss'], 6) for r in plain['steps']]}, grad_norm "
            f"{[round(r['grad_norm'], 6) for r in res['steps']]} vs "
            f"{[round(r['grad_norm'], 6) for r in plain['steps']]}; "
            f"{statistics.median(res['ms'][1:]):.3f} ms/step (steps 2-"
            f"{DDP_STEPS}; all {[round(x, 3) for x in res['ms']]}), peak "
            f"{res['peak_gib']:.3f} GiB; {res['launches']:.0f} kernels per "
            f"step, the clip and update {res['update_launches']:.0f} of "
            f"them ({res['update_ms']:.3f} ms of device time); card {card}")
    no_kernel_launches("ococcnet optimizer layouts")
    for opt in ("flat", "stacked"):
        log(f"ococcnet {opt} optimizer against the tree's: "
            f"{runs['tree']['launches'] - runs[opt]['launches']:.0f} "
            f"kernels per step saved, clip and update "
            f"{runs['tree']['update_launches']:.0f} -> "
            f"{runs[opt]['update_launches']:.0f} kernels, "
            f"{runs['tree']['update_ms']:.3f} -> "
            f"{runs[opt]['update_ms']:.3f} ms")
    # the flat layout under data parallelism, as phase 38 (b) runs the tree
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        port = free_port()
        run_ranks([rank_argv("ococc_rank", r, 2, port, out, "flat")
                   for r in (0, 1)], "ococcnet flat optimizer ddp gloo x2")
        ranks = [torch.load(os.path.join(out, f"ococc_flat_2_{r}.pt"),
                            weights_only=False) for r in (0, 1)]
    for r, res in enumerate(ranks):
        compare_occ_steps(f"ococcnet flat optimizer ddp gloo rank {r} of 2 "
                          f"vs phase 38's plain step", res, plain)
        check_occ_step_metrics(f"ococcnet flat optimizer ddp rank {r}", res,
                               plain)
        log(f"ococcnet flat optimizer ddp gloo rank {r} of 2: batch "
            f"{DDP_OCC_BATCH // 2} per process, losses "
            f"{[round(x['loss'], 6) for x in res['steps']]} vs plain "
            f"{[round(x['loss'], 6) for x in plain['steps']]}, "
            f"{statistics.median(res['ms'][1:]):.3f} ms/step (steps 2-"
            f"{DDP_STEPS}; all {[round(x, 3) for x in res['ms']]}), peak "
            f"{res['peak_gib']:.3f} GiB; one card: the collectives' "
            f"overhead, not scaling; card {card}")
    ranks_bit_equal("ococcnet flat optimizer ddp", ranks)


def check_occ_step_metrics(what, res, plain):
    """Every step's losses and ``grad_norm`` of ``res`` at phase 38's bars
    of its plain step."""
    for k, (got, ref) in enumerate(zip(res["steps"], plain["steps"])):
        for key, v in ref.items():
            tol = (OCC_STEP_GRAD_NORM_RTOL * v if key == "grad_norm"
                   else OCC_STEP_LOSS_ATOL)
            if not abs(got[key] - v) <= tol:
                raise AssertionError(f"{what} step {k + 1}: {key} "
                                     f"{got[key]} vs {v}")


def phase_surgery(dev, occ_dir, fsd_ckpt, keep):
    """36. Surgery: publish phase 8's checkpoint twice under ``keep`` (the
    same ``-{hash8}`` name; the optimizer state gone) and hold its predict on
    the card, restored through ``restore_params``, to the source
    checkpoint's bit for bit (deterministic kernels); then transplant the
    FSD checkpoint's ``vfe.`` / ``unet.`` into a one-step CTRL-with-
    segmentor checkpoint through ``tools/publish_model.py`` and run one
    CTRL step from the result (``training/trainer.py::train`` resumes at
    step 0 with a fresh AdamW). Returns the release's directory."""
    src = os.path.join(occ_dir, "work", "ckpt")
    cfg = train_cli.ococc_train_config(dtype="bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [publish_cli.main(["publish", src, "--out",
                                  os.path.join(keep, name)])
                for name in ("release", "again")]
        if outs[0].split("-")[-1] != outs[1].split("-")[-1]:
            raise AssertionError(f"publish: hashes differ {outs}")
        step, params = surgery.restore_params(outs[0])
        published = torch.load(glob.glob(os.path.join(outs[0], "*.pt"))[0],
                               weights_only=True)
        if "optimizer" in published or step != OCC_TRAIN_STEPS:
            raise AssertionError(f"publish: {sorted(published)}, step "
                                 f"{step}")
        batch = synthetic_batch(cfg, batch_size=bench.OCC_BATCH, seed=0).to(
            dev)
        preds = []
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for restore in ("source", "published"):
                model = OcOccNetWithLoss(cfg, dev).eval()
                if restore == "source":
                    CheckpointManager(src).restore(model)
                else:
                    model.load_state_dict(params)
                with torch.no_grad():
                    preds.append(model.predict(batch))
        finally:
            torch.use_deterministic_algorithms(False)
        differ = [k for k, v in preds[0].items()
                  if not torch.equal(v, preds[1][k])]
        if differ:
            raise AssertionError(f"publish: predict differs in {differ}")
        log(f"surgery publish: {outs[0]} (sha256 "
            f"{json.load(open(os.path.join(outs[0], 'PUBLISH.json')))['sha256'][:16]}"
            f"..., the same name twice), step {step}, no optimizer state; "
            f"predict (bf16, batch {bench.OCC_BATCH}) from restore_params "
            f"equals the source checkpoint's in all {len(preds[0])} outputs")
        del model, preds
        torch.cuda.empty_cache()

        ctrl = seg_config()
        ds = TrackletDataset(**dataset_paths(os.path.join(occ_dir, "data")),
                             cfg=ctrl, class_names=ctrl.class_names)
        ctrl_work = os.path.join(tmp, "ctrl")
        train_tracklets(ctrl, ds, ctrl_work, total_steps=1, device=dev)
        warm = os.path.join(tmp, "warm", "ckpt")
        dst = os.path.join(ctrl_work, "ckpt")
        _, fsd = surgery.restore_params(fsd_ckpt)
        counts = {}
        for part in ("vfe.", "unet."):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                publish_cli.main(["transplant", fsd_ckpt, dst, "--out", warm,
                                  "--src-prefix", part, "--dst-prefix",
                                  "net.segmentor." + part])
            counts[part] = out.getvalue().splitlines()[0]
            log(f"surgery transplant {part}*: " + out.getvalue().strip()
                .replace("\n", "; "))
            dst = warm
        _, warmed = surgery.restore_params(warm)
        copied = [n for n in warmed if n.startswith("net.segmentor.")
                  and n[len("net.segmentor."):] in fsd and torch.equal(
                      warmed[n], fsd[n[len("net.segmentor."):]])]
        if not copied:
            raise AssertionError(f"transplant copied nothing: {counts}")
        stamps = []
        done = train_tracklets(
            ctrl, ds, os.path.dirname(warm), total_steps=1, device=dev,
            hooks=[lambda s, m: stamps.append(float(m["loss"]))])
        if done != 1 or len(stamps) != 1 or not abs(stamps[0]) < float(
                "inf"):
            raise AssertionError(f"ctrl step from the transplant: {done} "
                                 f"steps, losses {stamps}")
        log(f"surgery transplant: {len(copied)} segmentor tensors equal "
            f"FSD's after the transplant; one CTRL step from it at step 0, "
            f"loss {stamps[0]:.6f}; card {card_info()}")
        no_kernel_launches("surgery")
    return outs[0]


def bench_cli(argv):
    """``tools/benchmark.py``'s ``main(argv)`` in this process: its JSON
    line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def phase_bench_ckpt(dev, occ_dir, release, sst_dir, cp_work, fsd_work):
    """48. The benchmark CLI on trained weights (``--ckpt-dir``) and at
    other batches (``--batch``): ``ococcnet`` on phase 8's training
    checkpoint at each of ``BENCH_CKPT_BATCHES`` and on phase 36's release
    at the default batch, ``sst --dtype float32`` on phase 5's float32
    checkpoint, ``centerpoint`` on phase 14's and ``fsd`` on phase 19's,
    each for ``BENCH_CKPT_FRAMES`` timed calls at full width: each line's
    ``ckpt_step`` and ``params_hash`` those of the file it loaded
    (``surgery.tree_hash``), every output finite and of the predict
    shapes, OcOccNet's tracklets per call the ``--batch``; SST's 12 forward
    window-attention launches per level per predict call and no backward
    one, none on the other families. Returns SST's forward launches."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    occ_ckpt = os.path.join(occ_dir, "work", "ckpt")
    # (name, argv, checkpoint, OcOccNet's tracklets per call)
    runs = [(f"ococcnet --batch {b}", ["ococcnet", "--batch", str(b)],
             occ_ckpt, b) for b in BENCH_CKPT_BATCHES]
    runs += [("ococcnet (published)", ["ococcnet"], release, bench.OCC_BATCH),
             ("sst --dtype float32", ["sst", "--dtype", "float32"],
              os.path.join(sst_dir, "work", "ckpt"), None),
             ("centerpoint", ["centerpoint"], os.path.join(cp_work, "ckpt"),
              None),
             ("fsd", ["fsd"], os.path.join(fsd_work, "fsd", "ckpt"), None)]
    per_level = 2 * bench.sst_config().sst.num_blocks
    n_fsd = train_cli.fsd_train_config().max_clusters
    frame_shapes = {"sst": (500, 7), "centerpoint": (500, 9),
                    "fsd": (n_fsd, 7)}
    sst_fwd = collections.Counter()
    card = card_info()
    for name, argv, ckpt, batch in runs:
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        t = time.perf_counter()
        res = bench_cli(argv + ["--ckpt-dir", ckpt, "--frames",
                                str(BENCH_CKPT_FRAMES)])
        wall = time.perf_counter() - t
        fwd, bwd = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
        step, state = surgery.restore_params(ckpt)
        digest = surgery.tree_hash(state)
        if (res["ckpt_step"], res["params_hash"]) != (step, digest):
            raise AssertionError(f"benchmark {name}: weights "
                                 f"{res['ckpt_step']} {res['params_hash']}, "
                                 f"the file's {step} {digest}")
        family = argv[0]
        if family == "ococcnet":
            B = res["batch"]
            expect = ococc_shapes(bench.occ_bench_config(), B)
            shapes = {k: tuple(v) for k, v in res["shapes"].items()}
            if B != batch or shapes != expect or not res["finite"]:
                raise AssertionError(f"benchmark {name}: batch {B}, shapes "
                                     f"{shapes} (expected {expect}), finite "
                                     f"{res['finite']}")
            unit = f"ms per batch of {B} ({res['fps']:.1f} tracklets/s)"
            expect_fwd = {}
        else:
            n = frame_shapes[family]
            got = [tuple(x) for x in res["outputs"]["shapes"]]
            if got != [n, n[:1], n[:1], n[:1]] or not res["outputs"][
                    "finite"]:
                raise AssertionError(f"benchmark {name}: outputs "
                                     f"{res['outputs']}")
            unit = "ms per frame"
            calls = res["predict_calls"]
            expect_fwd = ({T: per_level * calls for _, T in ATTN_SHAPES}
                          if family == "sst" else {})
        if fwd != expect_fwd or bwd:
            raise AssertionError(f"benchmark {name}: window-attention "
                                 f"launches {fwd} / backward {bwd}, "
                                 f"expected {expect_fwd}")
        if family == "sst":
            sst_fwd.update(fwd)
        log(f"benchmark {name} --ckpt-dir (step {step}, params_hash "
            f"{digest[:16]}...): {res['latency_ms']:.3f} {unit}, median of "
            f"{BENCH_CKPT_FRAMES} (mean {res['mean_ms']:.3f}); "
            f"window-attention launches {fwd or 0}"
            + (f" ({per_level} per level per call over {calls} calls)"
               if family == "sst" else "")
            + f"; {wall:.1f} s with the model's build; card {card}")
    return sst_fwd


def device_trace(fn, calls=5):
    """Trace ``calls`` calls of ``fn()`` on the card: the kernels and copies
    it ran per call, their summed device ms per call, and the traced wall
    ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in kernels) / calls,
            sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
            wall_ms / calls)


BUNDLE_SERVE = """
import statistics, sys, time, torch
""" + inspect.getsource(device_trace) + """
class Block:
    def find_spec(self, name, path=None, target=None):
        parts = name.split('.')
        if parts[0] == 'objectcentricocccompletion_torch' and \\
                parts[1:2] and parts[1] in ('models', 'ops', 'configs'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
from objectcentricocccompletion_torch.serving import load_bundle
root, reps = sys.argv[1], int(sys.argv[2])
for layout in sys.argv[3:]:
    run = load_bundle(f'{root}/{layout}').run
    batch = [x.cuda() for x in torch.load(f'{root}/batch_{layout}.pt')]
    got = run(batch)
    times = []
    for _ in range(reps + 3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run(batch)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    torch.save({'out': {k: v.cpu() for k, v in got.items()},
                'ms': statistics.median(times[3:]),
                'trace': device_trace(lambda: run(batch))},
               f'{root}/served_{layout}.pt')
print('served without the model code:', sorted(
    m for m in sys.modules if m.startswith('objectcentricocccompletion')))
"""


def phase_serving(dev):
    """37. Serving export: ``save_bundle`` of ``OcOccNetConfig()`` (float32,
    TF32 off) on the card in the packed and the dense layout, then
    ``load_bundle`` of both in one fresh process whose imports of the
    port's ``models``, ``ops`` and ``configs`` raise: served against live
    predict at the OcOccNet phase's float32 bar (``FP32_OCC_CPU_ATOL``);
    the export's seconds, the bundle's MB and ms per batch of
    ``bench.OCC_BATCH`` served against live (both timed on a batch already
    on the card), and a trace of each: kernels, device busy and wall ms
    per batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    with tempfile.TemporaryDirectory() as tmp:
        rows = {}
        for layout in bench.LAYOUTS:
            cfg = bench.ococcnet_config("float32", layout)
            model = bench.build_ococcnet(cfg, dev, seed=0)
            batch = synthetic_batch(cfg, batch_size=bench.OCC_BATCH, seed=0)
            t = time.perf_counter()
            save_bundle(os.path.join(tmp, layout), cfg, model.state_dict(),
                        batch, device=dev)
            export_s = time.perf_counter() - t
            sizes = {os.path.basename(p): os.path.getsize(p) / 1e6
                     for p in glob.glob(os.path.join(tmp, layout, "*"))}
            torch.save(tuple(batch), os.path.join(tmp, f"batch_{layout}.pt"))
            b = batch.to(dev)
            with torch.no_grad():
                live = {k: v.cpu() for k, v in model.predict(b).items()}
                live_ms = median_ms(lambda: model.predict(b),
                                    reps=SERVE_TIMED)
                live_trace = device_trace(lambda: model.predict(b))
            rows[layout] = (export_s, sizes, live, live_ms, live_trace)
            del model
            torch.cuda.empty_cache()
        run_ranks([[sys.executable, "-c", BUNDLE_SERVE, tmp,
                    str(SERVE_TIMED), *bench.LAYOUTS]], "serving bundles")
        served = {layout: torch.load(os.path.join(tmp, f"served_{layout}.pt"),
                                     weights_only=True)
                  for layout in bench.LAYOUTS}
    for layout, (export_s, sizes, live, live_ms, live_trace) in rows.items():
        got = served[layout]
        err = max(float((got["out"][k].float() - v.float()).abs().max())
                  for k, v in live.items())
        if set(got["out"]) != set(live) or not err <= FP32_OCC_CPU_ATOL:
            raise AssertionError(f"serving {layout}: served vs live {err}")
        log(f"serving {layout} (float32, batch {bench.OCC_BATCH}): export "
            f"{export_s:.1f} s, bundle {sum(sizes.values()):.1f} MB ("
            + ", ".join(f"{k} {v:.1f}" for k, v in sorted(sizes.items()))
            + f"), served {got['ms']:.3f} ms per batch vs live "
            f"{live_ms:.3f}, max abs difference {err:.3e} (bar "
            f"{FP32_OCC_CPU_ATOL}); traced per batch, served vs live: "
            f"{got['trace'][0]:.0f} vs {live_trace[0]:.0f} kernels and "
            f"copies, device busy {got['trace'][1]:.3f} vs "
            f"{live_trace[1]:.3f} ms, wall {got['trace'][2]:.3f} vs "
            f"{live_trace[2]:.3f} ms; card {card}")
    no_kernel_launches("serving")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        log(f"nvcc {name}: {text.strip()}")
    card = card_info()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    with tempfile.TemporaryDirectory() as keep:
        sst_dir = os.path.join(keep, "sst")
        occ_dir = os.path.join(keep, "ococcnet")
        t = time.perf_counter()
        rows = phase_kernel_vs_plain()
        log(f"phase kernel-vs-plain: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        launches, _ = phase_inference(dev)
        log(f"phase inference: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        fp32_fwd = phase_fp32_model_check(dev)
        log(f"phase fp32 check: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        bwd_rows = phase_bwd_kernel_vs_plain()
        log(f"phase backward kernel-vs-plain: "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_model_occupancy()
        log(f"phase model occupancy: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        train_fwd, train_bwd = phase_training(dev, "bfloat16")
        log(f"phase training: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        fp32_train_fwd, fp32_train_bwd = phase_training(dev, None, sst_dir)
        log(f"phase fp32 training (default dtype): "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_fp32_grad_check(dev)
        log(f"phase fp32 gradient check: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_ococcnet(dev)
        log(f"phase ococcnet: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_ococc_training(dev, occ_dir)
        log(f"phase ococcnet training: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_ococc_fp32_step(dev)
        log(f"phase ococcnet fp32 step: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_ococc_eval(dev, occ_dir)
        log(f"phase ococcnet evaluation: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_eval_fp32_check(dev)
        log(f"phase evaluation fp32 check: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        eval_fwd = phase_sst_eval(dev, sst_dir)
        log(f"phase sst evaluation: {time.perf_counter() - t:.1f} s")
        cp_frames = os.path.join(sst_dir, "frames")
        cp_work = os.path.join(keep, "centerpoint")
        cp_step = []
        for name, run in (
                ("centerpoint inference", lambda: phase_centerpoint(dev)),
                ("centerpoint card vs CPU",
                 lambda: phase_cp_card_vs_cpu(dev)),
                ("centerpoint training",
                 lambda: cp_step.extend(
                     phase_cp_training(dev, cp_frames, cp_work))),
                ("centerpoint fp32 step", lambda: phase_cp_fp32_step(dev)),
                ("centerpoint evaluation",
                 lambda: phase_cp_eval(dev, cp_frames, cp_work))):
            t = time.perf_counter()
            run()
            log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        fsd_work = os.path.join(keep, "fsd")
        for name, run in (
                ("fsd inference", lambda: phase_fsd(dev)),
                ("fsd card vs CPU", lambda: phase_fsd_card_vs_cpu(dev)),
                ("fsd training",
                 lambda: phase_fsd_training(dev, cp_frames, fsd_work)),
                ("fsd2 fp32 step", lambda: phase_fsd2_fp32_step(dev)),
                ("fsd evaluation",
                 lambda: phase_fsd_eval(dev, cp_frames, fsd_work))):
            t = time.perf_counter()
            run()
            log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        for name, run in (
                ("fsdpp inference", lambda: phase_fsdpp(dev)),
                ("fsdpp card vs CPU", lambda: phase_fsdpp_card_vs_cpu(dev)),
                ("fsdpp training",
                 lambda: phase_fsdpp_training(dev, cp_frames, fsd_work)),
                ("fsdpp fp32 window step",
                 lambda: phase_fsdpp_fp32_step(dev)),
                ("fsdpp evaluation",
                 lambda: phase_fsdpp_eval(dev, cp_frames, fsd_work)),
                ("W8 training",
                 lambda: phase_w8_training(dev, cp_frames, fsd_work))):
            t = time.perf_counter()
            run()
            log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_annotator(dev)
        log(f"phase annotator: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_data_prep(dev)
        log(f"phase data prep: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        aug_fwd, aug_bwd = phase_aug_training(dev, cp_frames, fsd_work)
        log(f"phase augmented training: {time.perf_counter() - t:.1f} s")
        for name, run in (
                ("A ctrl + segmentor",
                 lambda: phase_ctrl_segmentor(dev, occ_dir)),
                ("B remat", lambda: phase_remat(dev)),
                ("C loader workers",
                 lambda: phase_loader_workers(dev, occ_dir)),
                ("D votenet", lambda: phase_votenet(dev, keep))):
            t = time.perf_counter()
            run()
            log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        nus_fwd, nus_bwd = phase_nuscenes(dev, keep)
        log(f"phase E nuscenes: {time.perf_counter() - t:.1f} s")
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        t = time.perf_counter()
        release = phase_surgery(dev, occ_dir,
                                os.path.join(fsd_work, "fsd", "ckpt"), keep)
        log(f"phase 36 surgery: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_serving(dev)
        log(f"phase 37 serving: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        plain = phase_ococc_ddp(dev)
        log(f"phase 38 ococcnet ddp: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        ddp_fwd, ddp_bwd = phase_sst_ddp(dev)
        log(f"phase 39 sst ddp: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_sharded_eval(dev, occ_dir)
        log(f"phase 40 sharded evaluation: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_model_parallel(dev, plain)
        log(f"phase 41-43 model parallelism: "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_mp_cli(dev, occ_dir)
        log(f"phase 44 model-parallel cli: {time.perf_counter() - t:.1f} s")
        for name, run in (
                ("45 centerpoint column layout", lambda: phase_cp_column(dev)),
                ("46 centerpoint column training",
                 lambda: phase_cp_column_training(dev, cp_frames, cp_work,
                                                  cp_step)),
                ("47 optimizer layouts",
                 lambda: phase_opt_layouts(dev, plain))):
            t = time.perf_counter()
            run()
            log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        del plain
        torch.cuda.empty_cache()
        t = time.perf_counter()
        bench_fwd = phase_bench_ckpt(dev, occ_dir, release, sst_dir, cp_work,
                                     fsd_work)
        log(f"phase 48 benchmark on checkpoints: "
            f"{time.perf_counter() - t:.1f} s")

    # launches on the model's paths: bf16 inference and training run the
    # bf16 kernels, the float32 frame, float32, augmented, nuScenes and
    # data-parallel training (both ranks), the SST evaluation and the
    # benchmark on the float32 checkpoint the 3xTF32 ones
    src = "objectcentricocccompletion_torch/csrc/"
    fwd_tpu = "objectcentricocccompletion_tpu/ops/pallas_attention.py:25"
    bwd_tpu = ("benchmarks/repro_attn_bwd.py:124 (_attn_bwd_kernel) and :40 "
               "(_attn_bwd_kernel_fullstore)")
    kernels = []
    for dtype, tag, fwd_src, bwd_src, fwd_n, bwd_n in (
            (torch.bfloat16, "tc", "window_attention_tc.cu",
             "window_attention_bwd_tc.cu",
             {T: launches[T] + train_fwd[T] for _, T in ATTN_SHAPES},
             train_bwd),
            (torch.float32, "fp32", "window_attention.cu",
             "window_attention_bwd.cu",
             {T: fp32_fwd[T] + fp32_train_fwd[T] + eval_fwd[T] + aug_fwd[T]
              + nus_fwd[T] + ddp_fwd[T] + bench_fwd[T]
              for _, T in ATTN_SHAPES},
             {T: fp32_train_bwd[T] + aug_bwd[T] + nus_bwd[T] + ddp_bwd[T]
              for _, T in ATTN_SHAPES})):
        for W, T in ATTN_SHAPES:
            kernels.append(dict(
                name=f"window_attention_{tag}_T{T}", route="cuda",
                source=src + fwd_src, replaces=fwd_tpu, launches=fwd_n[T],
                **rows[(T, dtype)]))
        for W, T in ATTN_SHAPES:
            kernels.append(dict(
                name=f"window_attention_bwd_{tag}_T{T}", route="cuda",
                source=src + bwd_src, replaces=bwd_tpu, launches=bwd_n[T],
                **bwd_rows[(T, dtype)]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
