"""One rank of the port's data-parallel runs on the CPU (gloo), for
``tests/test_torch_ddp.py``, ``tests/test_torch_ddp_opt_layouts.py`` and
``tests/test_torch_multiproc_eval.py``:

    python tests/torch_ddp_worker.py CASE[,CASE...] RANK WORLD PORT OUT

joins ``WORLD`` processes at ``127.0.0.1:PORT``, runs each ``CASE`` in turn
on its slice of the case's global batch, in one process group, and writes
``OUT/{CASE}.rank{RANK}.pt``. The cases' inputs are built here from seeds,
so that a test builds the same ones for its one-process reference. Imports
no JAX.
"""
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from objectcentricocccompletion_torch.configs.ococcnet_config import (  # noqa: E402,E501
    tiny_config)
from objectcentricocccompletion_torch.data.synthetic import (  # noqa: E402
    synthetic_batch)
from objectcentricocccompletion_torch.data.tracklet import (  # noqa: E402
    TrackletBatch)
from objectcentricocccompletion_torch.models.sst_detector import (  # noqa: E402,E501
    SSTDetector, tiny_sst_detector_config)
from objectcentricocccompletion_torch.parallel import multihost  # noqa: E402
from objectcentricocccompletion_torch.parallel.train import (  # noqa: E402
    create_train_state, make_train_step)
from objectcentricocccompletion_torch.tools import benchmark as bench  # noqa: E402,E501
from objectcentricocccompletion_torch.training.detector_trainer import (  # noqa: E402,E501
    FrameBatch, make_detector_train_step)
from objectcentricocccompletion_torch.training.optim import (  # noqa: E402
    make_optimizer)

GLOBAL_BATCH = 4
NO_DROPOUT = dict(occ_dropout=0.0, attn_dropout=0.0, cls_dropout=0.0,
                  reg_dropout=0.0, latent_dropout=0.0, fusion_dropout=0.0)


def ococc_case(dropout: bool = True):
    """The tiny OcOccNet config (dropout on, or off) and a global batch of
    4 tracklets whose two halves hold different positive counts: the
    second half's GT is present in its first 3 frames only."""
    cfg = tiny_config()
    if not dropout:
        cfg = dataclasses.replace(cfg, **NO_DROPOUT)
    batch = synthetic_batch(cfg, batch_size=GLOBAL_BATCH, seed=3)
    valid = batch.gt_valid.clone()
    valid[2:, 3:] = False
    return cfg, batch._replace(gt_valid=valid)


def ococc_step(cfg, batch: TrackletBatch, opt: str = "tree") -> dict:
    """One training step of the tiny model (seed 0) on ``batch``, on the
    CPU, with the optimizer layout ``opt`` (``tree``, ``flat`` or
    ``stacked``: ``create_train_state(flat_opt= | stacked_opt=)``): its
    metrics, the parameters after it and the clipped gradients."""
    state = create_train_state(cfg, 10, "cpu", seed=0,
                               flat_opt=opt == "flat",
                               stacked_opt=opt == "stacked")
    model, optimizer, schedule = state[:3]
    metrics = make_train_step(
        model, optimizer, schedule, seed=1, flat_opt=opt == "flat",
        stacked_spec=state[3] if opt == "stacked" else None)(0, batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()})


def sst_case() -> FrameBatch:
    """Four tiny SST frames (``synth_frame``, seeds 0-3): two per rank of
    two, so each rank's first frame runs under DDP's ``no_sync``."""
    cfg = tiny_sst_detector_config()
    frames = [bench.train_batch(cfg, "cpu", num_real=3000, seed=s)
              for s in range(4)]
    return FrameBatch(*(torch.cat(parts) for parts in zip(*frames)))


def sst_step(batch: FrameBatch) -> dict:
    """One float32 training step of the tiny SST detector (seed 0) on
    ``batch``: metrics, parameters and clipped gradients."""
    model = SSTDetector(tiny_sst_detector_config(), "cpu",
                        torch.Generator().manual_seed(0))
    optimizer, schedule = make_optimizer(model.named_parameters(), 1e-3, 10)
    metrics = make_detector_train_step(model, optimizer, schedule)(0, batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None})


def eval_run(data_root: str, out_dir: str) -> dict:
    """``Evaluator.run`` of the tiny model (seed 0) on the tracklets
    written under ``data_root``, with the point-aggregation baseline and
    the Waymo metrics; the metrics."""
    from objectcentricocccompletion_torch.data.tracklet_dataset import (
        TrackletDataset)
    from objectcentricocccompletion_torch.evalx.evaluator import Evaluator
    from objectcentricocccompletion_torch.models.ococcnet import (
        OcOccNetWithLoss)
    cfg = tiny_config()
    ds = TrackletDataset(
        proposals_file=os.path.join(data_root, "proposals.pkl"),
        gt_candidates_file=os.path.join(data_root, "gt_candidates.pkl"),
        pose_file=os.path.join(data_root, "poses.pkl"),
        occ_anno_root=os.path.join(data_root, "occ_gt"), cfg=cfg,
        training=False, min_tracklet_length=1)
    model = OcOccNetWithLoss(cfg, "cpu", torch.Generator().manual_seed(0))
    return Evaluator(model, ds, cfg, device="cpu").run(
        out_dir, eval_occ_baseline=True)


def _slice(batch, rank: int, world: int):
    per = batch[0].shape[0] // world
    return type(batch)(*(x[rank * per:(rank + 1) * per] for x in batch))


def run_case(case, rank, world, out):
    if case in ("ococc", "ococc_nodrop"):
        cfg, batch = ococc_case(dropout=case == "ococc")
        return ococc_step(cfg, _slice(batch, rank, world))
    if case in ("ococc_flat", "ococc_stacked"):
        cfg, batch = ococc_case()
        return ococc_step(cfg, _slice(batch, rank, world),
                          opt=case.split("_")[1])
    if case == "sst":
        return sst_step(_slice(sst_case(), rank, world))
    if case == "eval":
        return eval_run(os.path.join(out, "data"), os.path.join(out, "eval"))
    raise ValueError(case)


def main(cases, rank, world, port, out):
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, "gloo", "cpu")
    try:
        for case in cases.split(","):
            torch.save(run_case(case, rank, world, out),
                       os.path.join(out, f"{case}.rank{rank}.pt"))
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5])
