"""The SST detector's training job through
``training/detector_trainer.py::make_detector_train_step``: one labelled
LiDAR frame a step, AdamW over two groups (``training/optim.py::
make_optimizer``, the recipe in the mix's ``optimizer``) after the
global-norm clip, steps issued back to back.

The pool: the mix's frames (``traffic.make_frames``, the scene of
``traffic/detect.json``), each with the scene's objects inside the grid as
its labels (``traffic.frame_labels``: each box labelled by its size row,
padded to ``max_gt``), kept on the host; each step copies its frame to the
card as the trainer does. The metrics are read back every ``log_interval``
steps.

The check follows the program step by step, as ``modes/train.py`` does:
its ``Mode`` records each checked step (the state before it, what it
reported, what it left) and runs the window's calls. Here the reference
(``reference/sst.py::step_grads``) runs each checked step's forward, losses
and backward from the program's state before it, on the same frame and
labels, and works out AdamW from that state and the program's clipped
gradient; step 0 starts from the seed's own weights and zero moments.
"""
from __future__ import annotations

import math
import sys

import torch

from .. import counts, traffic, weights
from ..reference import sst as ref
from . import port_config, train, worst

# the faults this timed path can have (the tests' cases; ``HALF_FAULT`` the
# one that reads highest short of the control, run on the card), the
# overrides that cut its mix to the CPU tests' size, and the card test's
# short window
FAULTS = ("unchanged", "half_boxes")
HALF_FAULT = "half_boxes"
TINY_MIX = dict(frames=3, log_interval=2, trace_calls=2)
CARD_SECONDS = 2.0


def build_detector(c: dict, dtype: str | None, device):
    """The port's ``SSTDetector`` of the configuration ``c``."""
    from objectcentricocccompletion_torch.models import \
        anchor_head as ah
    from objectcentricocccompletion_torch.models import sst as sst_mod
    from objectcentricocccompletion_torch.models.sst_detector import (
        SSTDetector, SSTDetectorConfig)
    a = port_config(c["anchors"])
    a["sizes"] = tuple(map(tuple, a["sizes"]))
    dcfg = SSTDetectorConfig(
        sst=sst_mod.SSTConfig(**port_config(c["sst"], dtype)),
        anchors=ah.AnchorConfig(**a),
        num_classes=c["num_classes"], neck_channels=c["neck_channels"],
        max_gt=c["max_gt"])
    with torch.device(device):
        return SSTDetector(dcfg, device)


class Mode(train.Mode):
    """``modes/train.py``'s recording, window calls and check over the
    detector's training step, with its own set-up and reference."""

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 dtype: str | None = None, fault: str | None = None):
        from objectcentricocccompletion_torch.training.detector_trainer \
            import FrameBatch, make_detector_train_step
        from objectcentricocccompletion_torch.training.optim import \
            make_optimizer
        self.cfg = c = config["config"]
        self.seed, self.dev, self.fault, self.mix = seed, device, fault, mix
        self.opt = opt = mix["optimizer"]
        self.model = build_detector(c, dtype, device)
        self.specs = ref.param_specs(c)
        self.model.load_state_dict(weights.draw(self.specs, seed, device))
        self.optimizer, schedule = make_optimizer(
            self.model.named_parameters(), opt["base_lr"],
            mix["total_steps"], weight_decay=opt["weight_decay"],
            peak_ratio=opt["peak_ratio"])
        if fault == "unchanged":
            self.optimizer.step = lambda *a, **k: None
        self.step_fn = make_detector_train_step(
            self.model, self.optimizer, schedule, grad_clip=opt["grad_clip"])

        s = c["sst"]
        frames = traffic.make_frames(mix, s["max_points"], s["pc_range"],
                                     seed, device, labels=True)
        grid = ref.grid_shape(s)[:2]
        dt = getattr(torch, dtype or s["compute_dtype"])
        pin = torch.device(device).type == "cuda"
        self.host, self.flops, self.bound_s, self.frames = [], [], [], []
        for pts, msk, boxes, classes in frames:
            w = ref.frame_work(c, pts, msk)
            self.flops.append(3 * counts.sst_flops(
                c, w["points"], w["voxels"], w["window_tokens"], grid))
            self.bound_s.append(sum(
                counts.attention_bound_ms(m, s["d_model"], dt,
                                          backward=True)[0] * 1e-3
                for i in range(2 * s["num_blocks"])
                for m in w["masks"][i % 2]))
            lab = traffic.frame_labels(boxes, classes, s["pc_range"],
                                       c["max_gt"])
            # the whole labels, as the reference takes them
            self.frames.append({k: v.cpu() for k, v in dict(
                points=pts, mask=msk, **lab).items()})
            if fault == "half_boxes":
                lab["gt_valid"] = lab["gt_valid"] & (torch.arange(
                    c["max_gt"], device=device) % 2 == 0)
            self.host.append(FrameBatch(*(
                x[None].cpu().pin_memory() if pin else x[None].cpu()
                for x in (pts, msk, lab["gt_boxes"], lab["gt_labels"],
                          lab["gt_valid"]))))
        del frames
        self.step = 0
        self.steps_done = 0
        self.tracing = False
        self.traced = []
        self.flops_done = 0
        self.stages = {"start": self._recorded(self.mix["checked_steps"])}

    def call(self):
        if self.tracing:
            self.traced.append(self.step % len(self.host))
        super().call()

    def trace_extra(self) -> dict:
        return {"attn_bwd_bound_s": sum(self.bound_s[i]
                                        for i in self.traced)}

    def _step_gaps(self, stage: str, row: dict) -> dict:
        """One step's gaps, as ``modes/train.py`` takes them: the loss's,
        relative; each leaf's gradient before the clip (the program's
        clipped gradient over its clip factor) and each leaf's change
        against AdamW's step from the program's state and clipped
        gradient, both as norms, over the larger of the reference's norm
        of that leaf and of the median leaf; the global norm's, relative."""
        dev, k = self.dev, row["step"]
        if k == 0:
            # the seed's weights and zero moments, drawn again
            params = weights.draw(self.specs, self.seed, dev)
            row["moments"] = tuple({n: torch.zeros_like(v)
                                    for n, v in params.items()}
                                   for _ in range(2))
        else:
            params = {n: v.to(dev) for n, v in row["params"].items()}
        frame = {n: v.to(dev) for n, v in
                 self.frames[k % len(self.frames)].items()}
        r = ref.step_grads(params, self.cfg, frame)
        del frame
        grads = {n: v.to(dev) for n, v in row["grads"].items()}
        moments = tuple({n: v.to(dev) for n, v in m.items()}
                        for m in row["moments"])
        want, _ = ref.adamw(params, moments, grads, self.opt,
                            self.mix["total_steps"], k)
        del moments
        cap = self.opt["grad_clip"]
        scale = row["norm"] / cap if row["norm"] >= cap else 1.0
        g_got = {n: float(g.norm()) * scale for n, g in grads.items()}
        g_ref = {n: float(g.norm()) for n, g in r["grads"].items()}
        c_got = {n: float((row["after"][n].to(dev) - p).norm())
                 for n, p in params.items()}
        c_ref = {n: float((want[n] - p).norm()) for n, p in params.items()}
        med_g = float(torch.tensor(list(g_ref.values())).median())
        med_c = float(torch.tensor(list(c_ref.values())).median())

        def gap_g(n):
            return abs(g_got[n] - g_ref[n]) / max(g_ref[n], med_g)

        def gap_c(n):
            return abs(c_got[n] - c_ref[n]) / max(c_ref[n], med_c)

        loss = r["losses"]["loss"]
        g = torch.tensor([gap_g(n) for n in g_ref])
        ch = torch.tensor([gap_c(n) for n in c_ref])
        for key, gap in (("grad", gap_g), ("change", gap_c)):
            for n in sorted(g_ref, key=gap, reverse=True)[:2]:
                print(f"{stage} step {k}: worst {key} leaf {n}: gap "
                      f"{gap(n):.3e}, gradient {g_got[n]:.6e} / "
                      f"{g_ref[n]:.6e}, change {c_got[n]:.6e} / "
                      f"{c_ref[n]:.6e} (program / reference)",
                      file=sys.stderr)
        print(f"{stage} step {k}: loss {row['loss']:.8e} / {loss:.8e}, "
              f"{r['losses']['num_pos']:.0f} positive anchors, norm "
              f"{row['norm']:.6e} / {r['norm']:.6e} (program / reference)",
              file=sys.stderr)
        return dict(
            loss_gap=worst(0.0, torch.tensor(
                [abs(row["loss"] - loss) / abs(loss)])),
            grad_median=(float(g.median()) if bool(torch.isfinite(g).all())
                         else math.inf),
            grad_gap=worst(0.0, g),
            norm_gap=worst(0.0, torch.tensor(
                [abs(row["norm"] - r["norm"]) / r["norm"]])),
            change_gap=worst(0.0, ch),
            change_median=(float(ch.median())
                           if bool(torch.isfinite(ch).all()) else math.inf))
