"""Offline tracklet refinement through ``OcOccNetWithLoss.predict`` and
``decode_occ_queries``, closed loop, one call at a time.

The pool: the mix's tracklets, padded to the evaluator's length buckets and
grouped into calls of ``frames_per_call`` padded frames, kept on the host.
Each call copies its batch to the card, predicts, decodes the occupancy of
each frame's queries from the shape latent, and copies boxes, scores and
occupancy logits back. The rate counts the real frames of real tracklets.
The check compares a seeded sample of the window's calls (the longest
bucket among them) with the plain reference on the same inputs.
"""
from __future__ import annotations

import torch
from torch.autograd.profiler import record_function

from .. import counts, traffic, weights
from ..reference import ococcnet as ref
from . import port_config, worst

# the faults this timed path can have (the tests' cases), the overrides
# that cut its mix to the CPU tests' size, and the card test's short window
FAULTS = ("answer",)
TINY_MIX = dict(tracklets=6, min_len=3, max_len=16, buckets=[8, 16],
                frames_per_call=32, queries_per_frame=32, full_range_m=40.0,
                check_calls=3, trace_calls=2)
CARD_SECONDS = 4.0


class Mode:
    def __init__(self, config: dict, mix: dict, seed: int, device,
                 dtype: str | None = None, fault: str | None = None):
        from objectcentricocccompletion_torch.configs.ococcnet_config import \
            OcOccNetConfig
        from objectcentricocccompletion_torch.models.ococcnet import \
            OcOccNetWithLoss
        self.cfg = dict(config["config"])
        self.seed, self.dev, self.fault, self.mix = seed, device, fault, mix
        cfg = OcOccNetConfig(**port_config(self.cfg, dtype))
        with torch.device(device):
            self.model = OcOccNetWithLoss(cfg, device)
        specs = ref.param_specs(self.cfg)
        self.model.load_state_dict(weights.draw(specs, seed, device))
        self.model.eval()

        K = mix["queries_per_frame"]
        tr = traffic.make_tracklets(mix, self.cfg["max_points_per_frame"], K,
                                    seed, device)
        self.calls = traffic.plan_calls(tr.length, mix["buckets"],
                                        mix["frames_per_call"],
                                        traffic.generator(seed, 4, "cpu"))
        self.host, self.flops = [], []
        pin = torch.device(device).type == "cuda"
        for c in self.calls:
            t = traffic.call_tensors(tr, c)
            kept = ref.kept_points(self.cfg, t)[:c.real_tracklets]
            self.flops.append(counts.ococcnet_flops(
                self.cfg, int(kept.sum()),
                [tr.length[i] for i in c.ids[:c.real_tracklets]], K))
            self.host.append({k: (v.cpu().pin_memory() if pin else v.cpu())
                              for k, v in t.items()})
        del tr
        self.pos = 0
        self.tracing = False
        self.done = []          # (call index, boxes, scores, occ) in order
        self.frames = 0
        self.flops_done = 0

    def _run(self, i: int):
        from objectcentricocccompletion_torch.data.tracklet import \
            TrackletBatch
        h = self.host[i]
        with record_function("h2d"):
            t = {k: v.to(self.dev, non_blocking=True) for k, v in h.items()}
            batch = TrackletBatch(
                points=t["points"], points_mask=t["points_mask"],
                rois=t["rois"], roi_scores=t["roi_scores"],
                frame_inds=t["frame_inds"], gt_boxes=t["rois"],
                gt_valid=t["points_mask"][..., 0], occ_points=t["queries"][
                    :, 0], occ_labels=t["frame_inds"],
                occ_mask=t["points_mask"][..., 0], occ_score=t["roi_scores"][
                    :, 0])
        with torch.no_grad():
            with record_function("predict"):
                out = self.model.predict(batch)
            with record_function("decode_occ"):
                occ = self.model.decode_occ_queries(out["shape_latent"],
                                                    t["queries"])
        with record_function("d2h"):
            boxes, scores, occ = (x.cpu() for x in
                                  (out["boxes"], out["scores"], occ))
        if self.fault == "answer":
            scores[0, 0] += 0.25
        return boxes, scores, occ

    def warm_up(self):
        """Every bucket's shape, twice."""
        first = {}
        for i, c in enumerate(self.calls):
            first.setdefault(c.L, i)
        for i in first.values():
            self._run(i)
            self._run(i)

    def call(self):
        i = self.pos % len(self.calls)
        self.pos += 1
        boxes, scores, occ = self._run(i)
        if not self.tracing:
            self.done.append((i, boxes, scores, occ))
            self.frames += self.calls[i].real_frames
            self.flops_done += self.flops[i]

    def finish(self):
        pass

    def end_to_end(self, window_s: float) -> dict:
        return {"refine_rate": self.frames / window_s}

    def start_trace(self):
        self.tracing = True

    def trace_extra(self) -> dict:
        return {}

    def free_program(self):
        del self.model

    def check(self) -> dict:
        """The widest gaps to the reference over a seeded sample of the
        window's calls: box components (m, rad), scores, occupancy
        logits."""
        n = min(self.mix["check_calls"], len(self.done))
        g = traffic.generator(self.seed, 5, "cpu")
        pick = torch.randperm(len(self.done), generator=g)[:n].tolist()
        longest = max(range(len(self.done)),
                      key=lambda j: (self.calls[self.done[j][0]].L, -j))
        if longest not in pick:
            pick[-1] = longest
        params = weights.draw(ref.param_specs(self.cfg), self.seed, self.dev)
        gaps = dict(box_gap=0.0, score_gap=0.0, occ_gap=0.0)
        for j in pick:
            i, boxes, scores, occ = self.done[j]
            batch = {k: v.to(self.dev) for k, v in self.host[i].items()}
            r = ref.refine(params, self.cfg, batch)
            for key, a, b in (("box_gap", boxes, r["boxes"]),
                              ("score_gap", scores, r["scores"]),
                              ("occ_gap", occ, r["occ"])):
                gaps[key] = worst(gaps[key], a.to(self.dev) - b)
        return gaps
