#!/usr/bin/env python3
"""Drive the PyTorch port's SST inference and training paths and its
OcOccNet serving path on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. Build every CUDA kernel of the path from ``objectcentricocccompletion_torch/
   csrc`` with nvcc (into ``build/``); print the build log and time and the
   card's name and power limit.
2. Hold the window-attention forward kernels against their plain PyTorch
   version on the card at both production shapes (small level W=3200, T=32;
   large level W=800, T=144; C=128, H=8) and at the shapes of
   ``CHECK_SHAPES`` (head dims 8 and 32, ragged T=20 and T=100), in float32
   (the CUDA-core kernel, atol 1e-5) and bfloat16 (the tensor-core kernel,
   atol 2e-2, compared in float32), with random masks and one window in
   eight fully masked (exactly the mean of v). Time the kernel, the plain
   version and ``scaled_dot_product_attention`` (a yardstick only; the port
   never calls it) with CUDA events, medians of 20 calls each, beside the
   bound (``attention_bound_ms``) and the exponentials' floor.
3. Run full-width ``SSTDetector(SSTDetectorConfig())`` inference in bfloat16
   through the benchmark entry point's functions on two seeded synthetic
   frames (dense: 150000 points; sparse: 20000). The launch counts are set
   to 0 just before this run and read just after: each frame must launch
   the kernel exactly 24 times (6 blocks x 2 shifts x 2 levels). Outputs
   must be finite and of the predict shapes. Then one frame in float32
   (TF32 off) with the kernel and with the plain attention, same weights,
   compared at a stated tolerance; and the same frame through the port on
   the CPU (the path the CPU tests hold to the JAX package).
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
5. Train full-width SST in bfloat16 through the port's training CLI
   (``tools/train.py sst``'s ``main``) for 6 steps on 3 file-backed
   synthetic frames at production scale (``write_synthetic_frames``:
   120000 points, 40 boxes). The launch counts are set to 0 just before
   and read after every step: each step must launch exactly 24 forward and
   24 backward kernels (12 per level). Every logged loss and ``grad_norm``
   must be finite, the parameters must have moved, and a checkpoint must
   exist. Prints ms/step (median of steps 3-6) and the peak memory.
6. One dense frame through ``SSTDetector.loss`` and backward in float32
   (TF32 off), at full width with the depth cut to 2 blocks (the time
   limit), with the kernels and with ``use_pallas_attention=False`` (the
   einsum differentiated by autograd), same weights: every parameter's
   gradient must agree within 1e-3 * its max |grad| + 1e-5 * the largest
   |grad| of the model. Phases 3 and 6 count the float32 kernels' launches
   (12 forward per level in the frame; 4 forward and 4 backward per level
   in the gradient check).
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
8. Print the kernels' JSON line (the bf16 tensor-core kernels and the
   float32 CUDA-core kernels, each level apart), then as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where ``torch.cuda.is_available()``
is false or the port's package is missing.
"""
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

import torch

from objectcentricocccompletion_torch.data.frame_dataset import (
    write_synthetic_frames)
from objectcentricocccompletion_torch.data.tracklet import TrackletBatch
from objectcentricocccompletion_torch.evalx.detector_eval import (
    make_predict_fn)
from objectcentricocccompletion_torch.models.ococcnet import (
    OcOccNetWithLoss)
from objectcentricocccompletion_torch.models.sst_detector import SSTDetector
from objectcentricocccompletion_torch.ops import _build
from objectcentricocccompletion_torch.ops import voxelize as vx
from objectcentricocccompletion_torch.ops import window_attention as wa
from objectcentricocccompletion_torch.tools import benchmark as bench
from objectcentricocccompletion_torch.tools import train as train_cli
from objectcentricocccompletion_torch.utils.device import card_info

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; bf16 tensor-core
# and float32 (non-tensor) FLOP/s; exp2 (16 per clock on each of 132 SMs at
# the 1.98 GHz boost clock)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_EX2 = 16 * 132 * 1.98e9
# exponentials per (query, key, head) of the bf16 kernels: forward, backward
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
# the same, plus cuDNN against oneDNN convolutions and GEMMs
FP32_CPU_ATOL = 1e-3
TIMED_FRAMES = 5
# backward kernel vs plain: float32 sums in another order over T keys
BWD_ATOL_FP32 = 1e-4
# bf16: one rounding of each output (8 bits) on values up to max|ref|
BWD_RTOL_BF16 = 2 ** -7
TRAIN_STEPS = 6
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
    """The bf16 kernels' exponentials (one per query, key and head of every
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
                f"{bound_ms:.4f} ms ({bound_by}) ex2 floor (bf16 kernel) "
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
                f"({bound_by}) ex2 floor (bf16 kernel) "
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
    parts, _ = model.backbone.partitions(vres)
    occ = {f"shift{s}_T{cap}": int(lp.num_windows)
           for s, levels in enumerate(parts) for lp, _, cap in levels}
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
    run of the port (the path the CPU tests hold to the JAX package)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench.sst_config("float32")
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
    return launches


def phase_training(dev):
    """Full-width bf16 training through the port's CLI; returns the launch
    counts of the run (forward, backward)."""
    per_level = 2 * bench.sst_config().sst.num_blocks   # one per layer
    expect = {32: per_level, 144: per_level}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "frames")
        t = time.perf_counter()
        infos = write_synthetic_frames(data, num_frames=3, num_points=120000,
                                       num_boxes=40, seed=0)
        log(f"training: wrote 3 synthetic frames in "
            f"{time.perf_counter() - t:.1f} s")
        work = os.path.join(tmp, "work")
        steps = []

        def hook(step, metrics):
            torch.cuda.synchronize()
            steps.append((step, time.perf_counter(), dict(wa.LAUNCHES),
                          dict(wa.BWD_LAUNCHES)))

        torch.cuda.reset_peak_memory_stats(dev)
        wa.LAUNCHES.clear()
        wa.BWD_LAUNCHES.clear()
        t0 = time.perf_counter()
        done = train_cli.main(
            ["sst", "--infos", infos, "--data-root", data, "--total-steps",
             str(TRAIN_STEPS), "--dtype", "bfloat16", "--log-interval", "1",
             "--work-dir", work, "--device", "cuda", "--seed", "0"],
            hooks=[hook])
        fwd, bwd = dict(wa.LAUNCHES), dict(wa.BWD_LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if done != TRAIN_STEPS or len(steps) != TRAIN_STEPS:
            raise AssertionError(f"training ran {len(steps)} steps")
        prev = (t0, {}, {})
        times = []
        for step, now, f, b in steps:
            df = {T: n - prev[1].get(T, 0) for T, n in f.items()}
            db = {T: n - prev[2].get(T, 0) for T, n in b.items()}
            if df != expect or db != expect:
                raise AssertionError(f"training step {step}: forward "
                                     f"launches {df}, backward {db}, "
                                     f"expected {expect} each")
            times.append((now - prev[0]) * 1e3)
            prev = (now, f, b)
        rows = [json.loads(line) for line in
                open(os.path.join(work, "metrics.jsonl"))]
        keys = ("loss", "loss_cls", "loss_bbox", "loss_dir", "grad_norm")
        if [r["step"] for r in rows] != list(range(1, TRAIN_STEPS + 1)) or \
                not all(abs(r[k]) < float("inf") for r in rows for k in keys):
            raise AssertionError(f"training metrics {rows}")
        for r in rows:
            log("training step " + " ".join(
                f"{k}={r[k]}" for k in ("step",) + keys + ("num_pos_anchors",
                                                           "frames_per_sec")))
        ckpt = os.path.join(work, "ckpt", f"step_{TRAIN_STEPS}.pt")
        if not os.path.exists(ckpt):
            raise AssertionError(f"no checkpoint at {ckpt}")
        trained = torch.load(ckpt, map_location="cpu",
                             weights_only=True)["model"]
    # the CLI's init: the same config and seed, on the CPU
    init = SSTDetector(train_cli.sst_train_config(dtype="bfloat16"), "cpu",
                       torch.Generator().manual_seed(0)).state_dict()
    # the attention key biases may stay: their exact gradient is 0 (the
    # softmax is invariant to them) and biases take no weight decay
    same = [n for n, p in init.items() if torch.equal(p, trained[n])]
    if any(not n.endswith(".k.bias") for n in same):
        raise AssertionError(f"parameters did not move: {same}")
    timed = times[TRAIN_TIMED_FROM - 1:]
    step_ms = statistics.median(timed)
    log(f"training: {TRAIN_STEPS} bf16 steps at full width, "
        f"{step_ms:.3f} ms/step (median of steps {TRAIN_TIMED_FROM}-"
        f"{TRAIN_STEPS}: {[round(x, 3) for x in timed]}; all "
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
    return fwd, bwd


def serve(model, batch, queries):
    """OcOccNet predict, then the occupancy decode of ``queries``."""
    with torch.inference_mode():
        out = model.predict(batch)
        out["occ_logits"] = model.decode_occ_queries(out["shape_latent"],
                                                      queries)
    return out


def check_ococc(what, out, cfg, B):
    """The JAX package's shapes, and every output finite."""
    L, D, K = cfg.reg_len, cfg.d_model, cfg.num_occ_samples
    expect = {"boxes": (B, L, 7), "scores": (B, L), "cls_logit": (B, L),
              "bbox_pred": (B, L, 7), "shape_latent": (B, L, D),
              "ae_latent": (B, L, D), "nonempty": (B, L),
              "occ_logits": (B, L, K)}
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
    log(f"phase backward kernel-vs-plain: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_model_occupancy()
    log(f"phase model occupancy: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    train_fwd, train_bwd = phase_training(dev)
    log(f"phase training: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    grad_fwd, grad_bwd = phase_fp32_grad_check(dev)
    log(f"phase fp32 gradient check: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_ococcnet(dev)
    log(f"phase ococcnet: {time.perf_counter() - t:.1f} s")

    # launches on the model's paths: bf16 inference and training run the
    # tensor-core kernels, the float32 frame and gradient check the
    # CUDA-core kernels
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
             {T: fp32_fwd[T] + grad_fwd[T] for _, T in ATTN_SHAPES},
             grad_bwd)):
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
