"""Training CLI of the port (counterpart of the JAX repository's
``tools/train.py``; the ``sst`` family so far).

    python -m objectcentricocccompletion_torch.tools.train sst \\
        --infos data/infos.pkl --data-root data --total-steps 1000 \\
        [--dtype bfloat16] [--tiny] [--device cuda] [--work-dir DIR]

Builds ``SSTDetector`` (the full-width ``SSTDetectorConfig()``, or the tiny
one with ``--tiny``), its weights drawn from a ``torch.Generator`` seeded
with ``--seed``, reads the frames with ``FrameDataset`` (``--tiny``: 4096
points and 32 boxes per frame, as the JAX CLI) and trains with
``train_detector`` on ``--device`` (``cuda`` unless the caller asks for
the CPU). ``write_synthetic_frames`` (``data/frame_dataset.py``) writes a
production-scale synthetic dataset for it.

The flags of the JAX CLI's frame branch are kept. Those of options not
ported yet (other model families and datasets, ``--occ-pred-root``,
``--num-sweeps``, ``--augment``, ``--disable-aug-after``, ``--gt-sample``)
raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Sequence

import torch

from ..data.frame_dataset import FrameDataset
from ..models.sst_detector import (SSTDetector, SSTDetectorConfig,
                                   tiny_sst_detector_config)
from ..training.detector_trainer import train_detector
from ..utils.device import resolve_device

FAMILIES = ["ococcnet", "ctrl", "centerpoint", "sst", "fsd", "fsd2",
            "fsdpp", "votenet"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("model", choices=FAMILIES, help="model family to train")
    p.add_argument("--infos", help="frame infos pkl")
    p.add_argument("--dataset", choices=["waymo", "argo2", "nuscenes",
                                         "lyft", "scannet", "sunrgbd"],
                   default="waymo", help="frame dataset family")
    p.add_argument("--data-root", help="frame data root")
    p.add_argument("--occ-pred-root", default=None,
                   help="merge predicted occupancy points (not ported)")
    p.add_argument("--work-dir", default="work_dirs/run")
    p.add_argument("--total-steps", type=int, default=None)
    p.add_argument("--ckpt-interval", type=int, default=1000)
    p.add_argument("--log-interval", type=int, default=50,
                   help="metrics.jsonl cadence (steps)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="tiny config for smoke runs")
    p.add_argument("--num-sweeps", type=int, default=0,
                   help="multi-sweep frames (not ported)")
    p.add_argument("--augment", action="store_true",
                   help="frame geometry augmentation (not ported)")
    p.add_argument("--disable-aug-after", type=int, default=None,
                   help="turn augmentation off from this step on (not "
                        "ported)")
    p.add_argument("--gt-sample", type=int, default=0,
                   help="GT copy-paste augmentation (not ported)")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the detector (parameters stay "
                        "float32)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def sst_train_config(tiny: bool = False, dtype: str | None = None
                     ) -> SSTDetectorConfig:
    cfg = tiny_sst_detector_config() if tiny else SSTDetectorConfig()
    if dtype:
        cfg = dataclasses.replace(cfg, sst=dataclasses.replace(
            cfg.sst, compute_dtype=dtype))
    return cfg


def main(argv=None,
         hooks: Sequence[Callable[[int, dict], None]] = ()) -> int:
    """Run the CLI on ``argv``; ``hooks`` go to ``train_detector`` (for a
    caller that drives training from Python). Returns the steps done."""
    args = parse_args(argv)
    if args.model != "sst":
        raise NotImplementedError(
            f"training of the {args.model!r} family is not ported yet")
    if args.dataset != "waymo":
        raise NotImplementedError(
            f"the {args.dataset!r} dataset is not ported yet")
    if args.disable_aug_after is not None:
        raise NotImplementedError("--disable-aug-after is not ported yet")
    if args.gt_sample > 0:
        raise NotImplementedError("--gt-sample is not ported yet")
    if not args.infos or not args.data_root:
        raise SystemExit(
            f"{args.model} training needs --infos and --data-root")
    dev = resolve_device(args.device)
    frame_kw = dict(max_points=4096, max_gt=32) if args.tiny else {}
    ds = FrameDataset(args.infos, args.data_root,
                      occ_pred_root=args.occ_pred_root,
                      augment=args.augment, num_sweeps=args.num_sweeps,
                      **frame_kw)
    print(f"dataset: {len(ds)} frames", flush=True)
    cfg = sst_train_config(args.tiny, args.dtype)
    model = SSTDetector(cfg, device=dev,
                        generator=torch.Generator().manual_seed(args.seed))
    return train_detector(model, ds, args.work_dir,
                          total_steps=args.total_steps or 1000,
                          ckpt_interval=args.ckpt_interval,
                          log_interval=args.log_interval, seed=args.seed,
                          device=dev, resume=not args.no_resume,
                          hooks=hooks)


if __name__ == "__main__":
    main()
