"""Sequential (multi-frame) training of FSD++ (counterpart of the JAX
package's ``training/seq_trainer.py``): a training sample is a window of
consecutive frames of one log; the model carries its point memory and seeds
across the window's frames, and every frame contributes its detection
losses.

The JAX step unrolls the window in one jitted function. The port runs the
frames in order and back-propagates each frame's share of the mean loss
before the next frame: the state a frame hands on is detached (no gradient
crosses frames in either package), so the gradients are those of the
window's mean loss.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..models.fsd import fsd_loss
from ..models.fsd_two_stage import two_stage_loss
from ..models.fsdpp import FSDPP, SequenceState, init_sequence_state
from ..ops import seeds as seed_ops
from ..utils.device import resolve_device
from .optim import clip_grad_global_norm_, make_optimizer, set_lr
from .trainer import CheckpointManager, MetricLogger


class SeqWindow(NamedTuple):
    points: torch.Tensor       # [W, N, C] consecutive frames
    points_mask: torch.Tensor  # [W, N]
    gt_boxes: torch.Tensor     # [W, M, 7]
    gt_labels: torch.Tensor    # [W, M]
    gt_valid: torch.Tensor     # [W, M]
    # offline seeds per frame (data/seed_store.SeedStore); None: the model
    # consumes its own carried seeds
    seed_boxes: torch.Tensor | None = None    # [W, S, 7]
    seed_labels: torch.Tensor | None = None   # [W, S]
    seed_scores: torch.Tensor | None = None   # [W, S]
    seed_valid: torch.Tensor | None = None    # [W, S]

    def to(self, device) -> "SeqWindow":
        return SeqWindow(*(None if t is None else t.to(device)
                           for t in self))

    def frame_seeds(self, w: int) -> seed_ops.Seeds | None:
        if self.seed_boxes is None:
            return None
        return seed_ops.Seeds(self.seed_boxes[w], self.seed_labels[w],
                              self.seed_scores[w], self.seed_valid[w])


class SequenceLoader:
    """Windows of ``window`` consecutive frames from the dataset's
    ``sequences()`` (or the whole dataset as one sequence), on the CPU; the
    JAX package's loader, draw for draw from ``numpy.random.RandomState(
    seed)``.

    ``sequential=True`` walks each sequence front to back in windows that
    do not overlap (the sequences in a new random order every epoch) and
    sets ``carry`` False at each sequence's start: the trainer carries the
    memory across the windows of one log. ``seed_store`` (a
    ``data/seed_store.SeedStore``) adds each frame's offline seeds; it needs
    a dataset with ``frame_meta(index) -> (segment, timestamp)``, which
    ``FrameDataset`` does not have (nor has the JAX package's)."""

    def __init__(self, dataset, window: int, seed: int = 0,
                 sequential: bool = False, seed_store=None):
        self.ds = dataset
        self.window = window
        self.rng = np.random.RandomState(seed)
        self.sequential = sequential
        self.seed_store = seed_store
        if hasattr(dataset, "sequences"):
            self.seqs = dataset.sequences()
        else:
            self.seqs = [list(range(len(dataset)))]
        self.seqs = [s for s in self.seqs if len(s) >= window]
        assert self.seqs, "no sequence long enough for the window"
        self.carry = False
        self._order: list = []
        self._seq_i = 0
        self._beg = 0

    def __iter__(self):
        return self

    def _build(self, seq, beg) -> SeqWindow:
        samples = [self.ds.build_sample(seq[beg + i], self.rng)
                   for i in range(self.window)]

        def stack(k):
            return torch.from_numpy(np.stack([s[k] for s in samples], 0))
        seeds = (None,) * 4
        if self.seed_store is not None:
            rows = [self.seed_store.get(*self.ds.frame_meta(seq[beg + i]))
                    for i in range(self.window)]
            seeds = tuple(torch.from_numpy(np.stack([r[j] for r in rows], 0))
                          for j in range(4))
        return SeqWindow(stack("points"), stack("points_mask"),
                         stack("gt_boxes"), stack("gt_labels"),
                         stack("gt_valid"), *seeds)

    def __next__(self) -> SeqWindow:
        if not self.sequential:
            self.carry = False
            seq = self.seqs[self.rng.randint(len(self.seqs))]
            beg = self.rng.randint(0, len(seq) - self.window + 1)
            return self._build(seq, beg)
        if not self._order:
            self._order = list(self.rng.permutation(len(self.seqs)))
            self._seq_i = 0
            self._beg = 0
        seq = self.seqs[self._order[self._seq_i]]
        self.carry = self._beg > 0
        out = self._build(seq, self._beg)
        self._beg += self.window
        if self._beg + self.window > len(seq):
            self._beg = 0
            self._seq_i += 1
            if self._seq_i >= len(self._order):
                self._order = []
        return out


def augment_seeds(cfg, seeds: seed_ops.Seeds, chain, noise):
    """One frame of the training seed augmentation: the dropout chained
    from the previous frame's ``chain`` (boxes, valid, keep; None on the
    window's first frame), then the FP insertion. Returns (augmented seeds
    of twice the capacity, the chain for the next frame)."""
    keep = seed_ops.seed_dropout_step(
        *(chain if chain is not None else (None,) * 3), seeds.boxes,
        seeds.valid, noise.drop, cfg.seed_drop_rate)
    kept = seed_ops.Seeds(seeds.boxes, seeds.labels, seeds.scores, keep)
    return (seed_ops.seed_fp_insertion(kept, noise.copy, noise.shift,
                                       cfg.seed_fp_rate),
            (seeds.boxes, seeds.valid, keep))


def make_seq_train_step(model: FSDPP, optimizer: torch.optim.Optimizer,
                        schedule: Callable[[int], float], window: int,
                        seed_aug: bool = True, grad_clip: float = 10.0):
    """``step_fn(step, batch, mem, noise=None, generator=None,
    overrides=None, record=None) -> (new_mem, metrics)``: one AdamW step at
    learning rate ``schedule(step)`` on the mean over the window's frames
    of ``two_stage_loss`` (``fsd_loss`` with ``two_stage=False``), each
    frame's taken on ``[points; the memory it was given]``, after a
    global-norm clip. The memory and the seeds carry across the frames and
    come back (detached) for the next window of the sequence.

    ``seed_aug`` applies the training seed augmentation (dropout chained
    across the window's frames, then FP insertion) where the config asks
    for it; its draws are ``noise`` (one ``SeedNoise`` per frame) or come
    from ``generator``. ``overrides`` (one ``(grouping, selection)`` per
    frame) and ``record`` go to the model's forward, for a caller that
    holds one run against another. The metrics are the loss dict's means
    over the frames and ``grad_norm`` (before clipping), 0-d tensors on the
    model's device."""
    cfg = model.cfg
    loss_call = two_stage_loss if cfg.two_stage else fsd_loss
    use_seed_aug = (seed_aug and cfg.use_seeds
                    and (cfg.seed_fp_rate > 0 or cfg.seed_drop_rate > 0))
    params = [p for group in optimizer.param_groups
              for p in group["params"]]
    device = next(model.parameters()).device

    def step_fn(step: int, batch: SeqWindow, mem: SequenceState,
                noise: Sequence | None = None,
                generator: torch.Generator | None = None,
                overrides: Sequence | None = None,
                record: list | None = None):
        model.train()
        batch = batch.to(device)
        m = mem.to(device)
        set_lr(optimizer, schedule(step))
        optimizer.zero_grad(set_to_none=True)
        sums: dict[str, torch.Tensor] = {}
        chain = None
        for w in range(window):
            seeds_in = batch.frame_seeds(w)
            if use_seed_aug:
                s = seeds_in if seeds_in is not None else m.seeds
                nz = noise[w] if noise is not None else \
                    seed_ops.draw_seed_noise(s.valid.shape[0], generator,
                                             device)
                seeds_in, chain = augment_seeds(cfg, s, chain, nz)
            merged = torch.cat([batch.points[w], m.memory], 0)
            grouping, selection = overrides[w] if overrides else (None, None)
            m, out = model(m, batch.points[w], batch.points_mask[w],
                           seeds_in, grouping, selection, record)
            losses = loss_call(out, merged, batch.gt_boxes[w],
                               batch.gt_labels[w], batch.gt_valid[w])
            (losses["loss"] / window).backward()
            for k, v in losses.items():
                v = v.detach().float()
                sums[k] = sums[k] + v if k in sums else v
        grad_norm = clip_grad_global_norm_(params, grad_clip)
        optimizer.step()
        return m, {**{k: v / window for k, v in sums.items()},
                   "grad_norm": grad_norm}

    return step_fn


def step_generator(seed: int, step: int) -> torch.Generator:
    """The seed augmentation's generator of training step ``step`` (its own
    seed, so that a resumed run draws what an uninterrupted one does)."""
    return torch.Generator().manual_seed((seed + 1) * 1_000_003 + step)


def train_fsdpp(model: FSDPP, dataset, work_dir: str, total_steps: int,
                window: int = 2, base_lr: float = 1e-5,
                ckpt_interval: int = 1000, log_interval: int = 50,
                seed: int = 0, resume: bool = True, sequential: bool = True,
                device="cuda",
                hooks: Sequence[Callable[[int, dict], None]] = (),
                disable_aug_after: int | None = None) -> int:
    """Train FSD++ (its weights as given) one window per step on
    ``device`` (``cuda`` unless the caller asks for the CPU). With
    ``sequential`` the windows walk each log front to back and the memory
    carries across the windows of a sequence (fresh at each log's start);
    otherwise random windows, each with a fresh memory. Metrics go to
    ``work_dir/metrics.jsonl`` every ``log_interval`` steps with
    ``windows_per_sec``, a checkpoint to ``work_dir/ckpt`` every
    ``ckpt_interval`` steps and at the end; with ``resume`` the newest
    checkpoint there is loaded first. Each hook is called as ``hook(step,
    metrics)`` after every step. ``disable_aug_after`` turns the dataset's
    augmentation and GT paste off from that step on, before its window is
    drawn, as ``train_detector`` does (the JAX function has no such
    option). Returns the number of steps done."""
    dev = resolve_device(device)
    model.to(dev)
    loader = SequenceLoader(dataset, window=window, seed=seed,
                            sequential=sequential)
    win = next(loader)
    win_carry = loader.carry
    mem0 = init_sequence_state(model.cfg, win.points.shape[-1], dev)
    optimizer, schedule = make_optimizer(model.named_parameters(), base_lr,
                                         total_steps)
    ckpt = CheckpointManager(f"{work_dir}/ckpt")
    start = 0
    if resume:
        restored = ckpt.restore(model, optimizer)
        if restored is not None:
            start = restored
    step_fn = make_seq_train_step(model, optimizer, schedule, window)
    t_last = time.time()
    mem = mem0
    with MetricLogger(work_dir, log_interval) as logger:
        for step in range(start, total_steps):
            if disable_aug_after is not None and step >= disable_aug_after:
                dataset.augment = False
                dataset.db_sampler = None
                disable_aug_after = None
            if step > start:
                batch, carry = next(loader), loader.carry
            else:
                batch, carry = win, win_carry
            if not carry:       # a sequence's start: fresh memory and seeds
                mem = mem0
            mem, metrics = step_fn(step, batch, mem,
                                   generator=step_generator(seed, step))
            for hook in hooks:
                hook(step + 1, metrics)
            if (step + 1) % log_interval == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = (time.time() - t_last) / log_interval
                t_last = time.time()
                logger.log(step + 1, {**metrics, "windows_per_sec": 1.0 / dt})
            if (step + 1) % ckpt_interval == 0 or step + 1 == total_steps:
                ckpt.save(step + 1, model, optimizer)
    return max(start, total_steps)
