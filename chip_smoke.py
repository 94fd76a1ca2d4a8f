#!/usr/bin/env python3
"""Drive the PyTorch port's SST inference path on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. Build every CUDA kernel of the path from ``objectcentricocccompletion_torch/
   csrc`` with nvcc (into ``build/``); print the build log and time and the
   card's name and power limit.
2. Hold the window-attention kernel against its plain PyTorch version on the
   card at both production shapes (small level W=3200, T=32; large level
   W=800, T=144; C=128, H=8), in float32 (atol 1e-5) and bfloat16 (atol
   2e-2, compared in float32), with random masks at realistic occupancy and
   fully masked windows. Time the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it) with CUDA events, medians of 20 calls each.
3. Run full-width ``SSTDetector(SSTDetectorConfig())`` inference in bfloat16
   through the benchmark entry point's functions on two seeded synthetic
   frames (dense: 150000 points; sparse: 20000). The launch counts are set
   to 0 just before this run and read just after: each frame must launch
   the kernel exactly 24 times (6 blocks x 2 shifts x 2 levels). Outputs
   must be finite and of the predict shapes. Then one frame in float32
   (TF32 off) with the kernel and with the plain attention, same weights,
   compared at a stated tolerance; and the same frame through the port on
   the CPU (the path the CPU tests hold to the JAX package).
4. Print the kernels' JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where ``torch.cuda.is_available()``
is false or the port's package is missing.
"""
import dataclasses
import json
import statistics
import sys
import time

import torch

from objectcentricocccompletion_torch.evalx.detector_eval import (
    make_predict_fn)
from objectcentricocccompletion_torch.models.sst_detector import SSTDetector
from objectcentricocccompletion_torch.ops import _build
from objectcentricocccompletion_torch.ops import voxelize as vx
from objectcentricocccompletion_torch.ops import window_attention as wa
from objectcentricocccompletion_torch.tools import benchmark as bench
from objectcentricocccompletion_torch.utils.device import card_info

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; bf16 tensor-core
# and float32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATTN_SHAPES = ((3200, 32), (800, 144))   # (W, T) of the two levels
C, H = 128, 8
# the kernel's other head dims (8: the tiny config; 32), checked only
OTHER_HEAD_DIMS = ((64, 16, 32, 4), (64, 144, 128, 4))   # (W, T, C, H)
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# float32 sums in another order through 12 attention layers and the neck,
# on maps of magnitude ~10
FP32_MODEL_ATOL = 1e-4
# the same, plus cuDNN against oneDNN convolutions and GEMMs
FP32_CPU_ATOL = 1e-3
TIMED_FRAMES = 5


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


def attention_inputs(W, T, C, dtype, gen):
    """q/k/v ~ N(0, 1); per window a random token count in [1, T] at
    random positions; one window in eight fully masked (unused slots)."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(W, T, C, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    count = torch.randint(1, T + 1, (W, 1), generator=gen, device=dev)
    rank = torch.rand(W, T, generator=gen, device=dev).argsort(-1)
    mask = rank < count
    mask[torch.arange(W, device=dev) % 8 == 7] = False
    return q, k, v, mask.contiguous()


def attention_bound_ms(W, T, dtype):
    elt = torch.finfo(dtype).bits // 8
    nbytes = 4 * W * T * C * elt + W * T          # q, k, v, out + mask
    flops = 4 * W * T * T * C                     # q.k and p.v
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_against_plain(W, T, C, H, dtype, gen):
    """Kernel vs plain on one random input; returns the inputs and errors
    (all keys, and fully masked windows against the mean of v)."""
    q, k, v, mask = attention_inputs(W, T, C, dtype, gen)
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
    for W, T, c, h in OTHER_HEAD_DIMS:
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
            bound_ms, bound_by = attention_bound_ms(W, T, dtype)
            rows[(T, dtype)] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=library_ms)
            log(f"attention W={W} T={T} {str(dtype)[6:]}: max_abs_err "
                f"{err:.3e} (fully masked {err_full:.3e}) kernel {ms:.4f} ms"
                f" plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms bound "
                f"{bound_ms:.4f} ms ({bound_by}); occupied tokens "
                f"{mask.float().mean().item():.3f}")
    return rows


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
        a, b = kern(pts, msk), plain(pts, msk)
        c = cpu(pts.cpu(), msk.cpu())
    compare_maps("fp32 model, kernel vs plain attention", a, b,
                 FP32_MODEL_ATOL)
    compare_maps("fp32 model, card vs CPU", a, c, FP32_CPU_ATOL)


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
    phase_fp32_model_check(dev)
    log(f"phase fp32 check: {time.perf_counter() - t:.1f} s")

    kernels = []
    for W, T in ATTN_SHAPES:
        row = rows[(T, torch.bfloat16)]
        kernels.append(dict(
            name=f"window_attention_T{T}", route="cuda",
            source="objectcentricocccompletion_torch/csrc/window_attention.cu",
            replaces="objectcentricocccompletion_tpu/ops/pallas_attention.py"
                     ":25",
            launches=launches[T], **row))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
