"""The OcOccNet training job through ``parallel/train.py::make_train_step``'s
``step_fn``: the tree optimizer (AdamW over two groups, the global-norm
clip), dropout on, steps issued back to back.

Set-up builds one step object and drives it from the seed through the
checked steps (0, 1, 2) with the pool's first batches, as the window's own
call does; the window then runs on from step 3 on the same object. The
batches come from a pool on the host, each step copying its batch to the
card as the loader's do; the metrics are read back every
``log_interval`` steps, as ``training/trainer.py::train`` reads them.

The check follows the program step by step. Each checked step keeps the
program's state before it (parameters and AdamW's moments), what the step
reported (the loss, the gradients' global norm before the clip) and what
it left (each leaf's clipped gradient, the parameters after it), on the
host. The reference then takes the state before each step, runs that
step's forward and backward on the same batch and dropout key, and works
out AdamW's step from that state and the program's clipped gradient.
Step 0 starts from the seed's own weights and zero moments, so the start
is checked from nothing the program made. The checked steps are those of
set-up and ``window_steps`` more through the window's own call once the
window has closed, from the state the window left.

A reference that ran on by itself would drift from the program: where the
loss has a kink within rounding of a step's point (the L1 box loss at a
residual of about 0, a group maximum with two near-equal points), the two
sides may take different gradients, and since the clip scales every
gradient by the global norm, one such step moves every leaf and every
later loss (PERF.md).
"""
from __future__ import annotations

import math
import sys

import torch
from torch.autograd.profiler import record_function

from .. import counts, traffic, weights
from ..reference import ococcnet as ref
from . import port_config, worst

# the faults this timed path can have (the tests' cases; ``HALF_FAULT`` the
# one that reads highest short of the control, run on the card), the
# overrides that cut its mix to the CPU tests' size, and the card test's
# short window
FAULTS = ("unchanged", "half_batch")
HALF_FAULT = "half_batch"
TINY_MIX = dict(batches=4, batch=2, length=8, full_range_m=40.0,
                log_interval=2, trace_calls=2)
CARD_SECONDS = 6.0


class Mode:
    def __init__(self, config: dict, mix: dict, seed: int, device,
                 dtype: str | None = None, fault: str | None = None):
        from objectcentricocccompletion_torch.configs.ococcnet_config import \
            OcOccNetConfig
        from objectcentricocccompletion_torch.data.tracklet import \
            TrackletBatch
        from objectcentricocccompletion_torch.models.ococcnet import \
            OcOccNetWithLoss
        from objectcentricocccompletion_torch.parallel.train import \
            make_train_step
        from objectcentricocccompletion_torch.training.optim import \
            make_optimizer
        self.cfg = dict(config["config"])
        self.seed, self.dev, self.fault, self.mix = seed, device, fault, mix
        self.drop_seed = int(seed) % (1 << 31)
        cfg = OcOccNetConfig(**port_config(self.cfg, dtype))
        with torch.device(device):
            self.model = OcOccNetWithLoss(cfg, device)
        self.specs = ref.param_specs(self.cfg)
        self.model.load_state_dict(weights.draw(self.specs, seed, device))
        self.optimizer, schedule = make_optimizer(
            self.model.named_parameters(), cfg.base_lr, mix["total_steps"],
            weight_decay=cfg.weight_decay, peak_ratio=cfg.lr_mult)
        if fault == "unchanged":
            self.optimizer.step = lambda *a, **k: None
        self.step_fn = make_train_step(self.model, self.optimizer, schedule,
                                       seed=self.drop_seed)

        B, L, K = mix["batch"], mix["length"], self.cfg["num_occ_samples"]
        tr = traffic.make_tracklets(dict(mix, tracklets=mix["batches"] * B),
                                    self.cfg["max_points_per_frame"], K,
                                    seed, device)
        pin = torch.device(device).type == "cuda"
        self.host, self.flops = [], []
        for b in range(mix["batches"]):
            t = traffic.train_batch(tr, list(range(b * B, (b + 1) * B)), L)
            kept = ref.kept_points(self.cfg, t)
            self.flops.append(3 * counts.ococcnet_flops(
                self.cfg, int(kept.sum()), [L] * B, K))
            if fault == "half_batch":
                t = {k: v[:B // 2] for k, v in t.items()}
            self.host.append(TrackletBatch(**{
                k: v.cpu().pin_memory() if pin else v.cpu()
                for k, v in t.items()}))
        # the whole batches, as the reference takes them
        self.batches = [{k: v.cpu() for k, v in traffic.train_batch(
            tr, list(range(b * B, (b + 1) * B)), L).items()}
            for b in range(mix["batches"])]
        del tr
        self.step = 0
        self.steps_done = 0
        self.tracing = False
        self.flops_done = 0
        self.stages = {"start": self._recorded(self.mix["checked_steps"])}

    def _recorded(self, n: int) -> list:
        """``n`` steps through the window's call, each with the state
        before it, what it reported and what it left, on the host."""
        names = dict(self.model.named_parameters())
        state = self.optimizer.state

        def host(t):
            return t.detach().to("cpu", copy=True)

        def moment(p, key):
            st = state.get(p, {})
            return host(st[key]) if key in st else torch.zeros(
                p.shape, dtype=p.dtype)

        rows = []
        for _ in range(n):
            row = dict(step=self.step,
                       params={k: host(p) for k, p in names.items()},
                       moments=tuple({k: moment(p, key)
                                      for k, p in names.items()}
                                     for key in ("exp_avg", "exp_avg_sq")))
            m = self._step()
            row.update(loss=float(m["loss"]), norm=float(m["grad_norm"]),
                       grads={k: host(p.grad) if p.grad is not None
                              else torch.zeros(p.shape, dtype=p.dtype)
                              for k, p in names.items()})
            rows.append(row)
        for a, b in zip(rows, rows[1:]):
            a["after"] = b["params"]
        rows[-1]["after"] = {k: host(p) for k, p in names.items()}
        return rows

    def _step(self):
        with record_function("train_step"):
            m = self.step_fn(self.step, self.host[self.step
                                                  % len(self.host)])
        self.step += 1
        return m

    def warm_up(self):
        pass

    def call(self):
        i = self.step % len(self.host)
        m = self._step()
        if self.step % self.mix["log_interval"] == 0:
            m = {k: float(v) for k, v in m.items()}
        if not self.tracing:
            self.steps_done += 1
            self.flops_done += self.flops[i]

    def finish(self):
        if torch.device(self.dev).type == "cuda":
            torch.cuda.synchronize(self.dev)

    def end_to_end(self, window_s: float) -> dict:
        return {"train_step_ms": 1e3 * window_s / self.steps_done}

    def start_trace(self):
        self.tracing = True

    def trace_extra(self) -> dict:
        return {}

    def after_window(self):
        """``window_steps`` steps through the window's call from the state
        the window left, recorded as set-up's are."""
        self.stages["window"] = self._recorded(self.mix["window_steps"])

    def free_program(self):
        del self.step_fn, self.optimizer, self.model

    def check(self) -> dict:
        """Every recorded step against the reference from the program's
        state before it; each compared number is the worst over the
        steps, each stage's own is printed beside it."""
        out = {}
        for stage, rows in self.stages.items():
            gaps = [self._step_gaps(stage, r) for r in rows]
            for k in gaps[0]:
                out[f"{stage}_{k}"] = max(g[k] for g in gaps)
        for k in ("loss_gap", "grad_median", "grad_gap", "norm_gap",
                  "change_gap", "change_median"):
            out[k] = max(out[f"{s}_{k}"] for s in self.stages)
        return out

    def _step_gaps(self, stage: str, row: dict) -> dict:
        """One step's gaps: the loss's, relative; each leaf's gradient
        before the clip (the program's clipped gradient over its clip
        factor, from the norm it reported) and each leaf's change against
        AdamW's step from the program's state and clipped gradient, both
        as norms, over the larger of the reference's norm of that leaf and
        of the median leaf; and the global norm's, relative."""
        dev, k = self.dev, row["step"]
        if k == 0:
            # the seed's weights and zero moments, drawn again
            params = weights.draw(self.specs, self.seed, dev)
            row["moments"] = tuple({n: torch.zeros_like(v)
                                    for n, v in params.items()}
                                   for _ in range(2))
        else:
            params = {n: v.to(dev) for n, v in row["params"].items()}
        batch = {n: v.to(dev) for n, v in
                 self.batches[k % len(self.batches)].items()}
        r = ref.step_grads(params, self.cfg, batch, self.drop_seed, k)
        del batch
        grads = {n: v.to(dev) for n, v in row["grads"].items()}
        moments = tuple({n: v.to(dev) for n, v in m.items()}
                        for m in row["moments"])
        want, _ = ref.adamw(params, moments, grads, self.cfg,
                            self.mix["total_steps"], k)
        del moments
        cap = self.cfg["grad_clip_norm"]
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
        c = torch.tensor([gap_c(n) for n in c_ref])
        for key, gap in (("grad", gap_g), ("change", gap_c)):
            for n in sorted(g_ref, key=gap, reverse=True)[:2]:
                print(f"{stage} step {k}: worst {key} leaf {n}: gap "
                      f"{gap(n):.3e}, gradient {g_got[n]:.6e} / "
                      f"{g_ref[n]:.6e}, change {c_got[n]:.6e} / "
                      f"{c_ref[n]:.6e} (program / reference)",
                      file=sys.stderr)
        return dict(
            loss_gap=worst(0.0, torch.tensor(
                [abs(row["loss"] - loss) / abs(loss)])),
            grad_median=(float(g.median()) if bool(torch.isfinite(g).all())
                         else math.inf),
            grad_gap=worst(0.0, g),
            norm_gap=worst(0.0, torch.tensor(
                [abs(row["norm"] - r["norm"]) / r["norm"]])),
            change_gap=worst(0.0, c),
            change_median=(float(c.median()) if bool(torch.isfinite(c).all())
                           else math.inf))
