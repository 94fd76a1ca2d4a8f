"""Detection over recorded drives through ``SSTDetector.predict``, closed
loop, one frame at a time.

The pool: the mix's LiDAR frames, kept on the host. Each call copies a
frame to the card, predicts, and copies the boxes, scores, labels and valid
mask back; its latency runs from the copy in to the boxes on the host. The
check matches a seeded sample of the window's frames against the plain
reference: the sorted scores, and each box against the nearest of the
reference's best-scoring boxes (centre and sizes relative where they
exceed 1 m).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

from .. import counts, traffic, weights
from ..reference import sst as ref
from . import port_config, worst

# the faults this timed path can have (the tests' cases), the overrides
# that cut its mix to the CPU tests' size, and the card test's short window
FAULTS = ("answer",)
TINY_MIX = dict(frames=3, check_frames=2, trace_calls=2)
CARD_SECONDS = 2.0

# a decoded yaw may differ by pi from the reference's where the direction
# logits or the wrap of the decode are this close to a tie
DIR_TIE = 1e-3
WRAP_TIE = 1e-4


class Mode:
    def __init__(self, config: dict, mix: dict, seed: int, device,
                 dtype: str | None = None, fault: str | None = None):
        from objectcentricocccompletion_torch.models import \
            anchor_head as ah
        from objectcentricocccompletion_torch.models import sst as sst_mod
        from objectcentricocccompletion_torch.models.sst_detector import (
            SSTDetector, SSTDetectorConfig)
        self.cfg = config["config"]
        self.seed, self.dev, self.fault, self.mix = seed, device, fault, mix
        c = self.cfg
        a = port_config(c["anchors"])
        a["sizes"] = tuple(map(tuple, a["sizes"]))
        dcfg = SSTDetectorConfig(
            sst=sst_mod.SSTConfig(**port_config(c["sst"], dtype)),
            anchors=ah.AnchorConfig(**a),
            num_classes=c["num_classes"], neck_channels=c["neck_channels"],
            max_gt=c["max_gt"])
        with torch.device(device):
            self.model = SSTDetector(dcfg, device)
        self.model.load_state_dict(weights.draw(ref.param_specs(c), seed,
                                                device))
        self.model.eval()
        self.max_out = config["assumed"]["max_out"]

        s = c["sst"]
        frames = traffic.make_frames(mix, s["max_points"], s["pc_range"],
                                     seed, device)
        self.flops, self.bound_s = [], []
        grid = ref.grid_shape(s)[:2]
        pin = torch.device(device).type == "cuda"
        self.host = []
        for pts, msk in frames:
            w = ref.frame_work(c, pts, msk)
            self.flops.append(counts.sst_flops(c, w["points"], w["voxels"],
                                               w["window_tokens"], grid))
            dt = getattr(torch, dtype or s["compute_dtype"])
            self.bound_s.append(sum(
                counts.attention_bound_ms(m, s["d_model"], dt)[0] * 1e-3
                for i in range(2 * s["num_blocks"])
                for m in w["masks"][i % 2]))
            self.host.append(tuple(x.cpu().pin_memory() if pin else x.cpu()
                                   for x in (pts, msk)))
        del frames
        self.pos = 0
        self.tracing = False
        self.traced = []
        self.done = []          # (frame index, outputs) in order
        self.latency = []
        self.flops_done = 0

    def _run(self, i: int):
        pts, msk = self.host[i]
        t0 = time.perf_counter()
        with record_function("h2d"):
            p = pts.to(self.dev, non_blocking=True)
            m = msk.to(self.dev, non_blocking=True)
        with torch.no_grad(), record_function("predict"):
            out = self.model.predict(p, m, self.max_out)
        with record_function("d2h"):
            out = tuple(x.cpu() for x in out)
        dt = time.perf_counter() - t0
        if self.fault == "answer":
            out[0][0, 0] += 0.5
        return out, dt

    def warm_up(self):
        for i in range(min(2, len(self.host))):
            self._run(i)

    def call(self):
        i = self.pos % len(self.host)
        self.pos += 1
        out, dt = self._run(i)
        if self.tracing:
            self.traced.append(i)
            return
        self.done.append((i, out))
        self.latency.append(dt)
        self.flops_done += self.flops[i]

    def finish(self):
        pass

    def end_to_end(self, window_s: float) -> dict:
        return {"detect_rate": len(self.done) / window_s,
                "detect_ms_p95": float(np.percentile(
                    np.asarray(self.latency) * 1e3, 95))}

    def start_trace(self):
        self.tracing = True

    def trace_extra(self) -> dict:
        return {"attn_fwd_bound_s": sum(self.bound_s[i]
                                        for i in self.traced)}

    def free_program(self):
        del self.model

    def check(self) -> dict:
        """The widest gaps to the reference over a seeded sample of the
        window's frames: between the sorted scores, and between each box
        and the nearest of the reference's best-scoring boxes."""
        n = min(self.mix["check_frames"], len(self.done))
        g = traffic.generator(self.seed, 5, "cpu")
        pick = torch.randperm(len(self.done), generator=g)[:n].tolist()
        params = weights.draw(ref.param_specs(self.cfg), self.seed, self.dev)
        gaps = dict(score_gap=0.0, box_gap=0.0)
        for j in pick:
            i, (boxes, scores, _, _) = self.done[j]
            boxes = boxes.float()
            pts, msk = (x.to(self.dev) for x in self.host[i])
            r = ref.detect(params, self.cfg, pts, msk)
            k = len(scores)
            top = torch.sort(r["scores"], descending=True).values[:k]
            gaps["score_gap"] = worst(gaps["score_gap"],
                                      scores.to(self.dev) - top)
            gaps["box_gap"] = worst(gaps["box_gap"],
                                    nearest_gap(boxes.to(self.dev), r, k))
        return gaps


def nearest_gap(boxes: torch.Tensor, r: dict, k: int) -> torch.Tensor:
    """Per box of the port, the widest component gap to the nearest of the
    reference's ``k + k // 2`` best-scoring boxes: centre and sizes relative
    to the reference's value where that is over 1 m, the yaw in radians. A
    yaw may differ by pi where the reference's direction logits or its
    decode's wrap lie within a tie."""
    cand = torch.argsort(r["scores"], descending=True)[:k + k // 2]
    rb = r["boxes"][cand]
    d = (boxes[:, None, :] - rb[None]).abs() / rb[None].abs().clamp(min=1)
    dyaw = torch.remainder(boxes[:, None, 6] - rb[None, :, 6] + math.pi,
                           2 * math.pi) - math.pi
    tie = (r["dir_margin"][cand] < DIR_TIE) | (r["wrap_margin"][cand]
                                              < WRAP_TIE)
    flip = (dyaw.abs() - math.pi).abs()
    dyaw = torch.where(tie[None], torch.minimum(dyaw.abs(), flip),
                       dyaw.abs())
    d = torch.cat([d[..., :6], dyaw[..., None]], -1)
    return d.amax(-1).amin(-1)

