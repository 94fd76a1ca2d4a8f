"""Training CLI of the port (counterpart of the JAX repository's
``tools/train.py``; every family but ``fsdpp`` and ``votenet``).

    python -m objectcentricocccompletion_torch.tools.train ococcnet \\
        --proposals data/proposals.pkl --gt-candidates data/cands.pkl \\
        --poses data/poses.pkl --occ-root data/occ_gt --total-steps 1000 \\
        [--ctrl-class veh] [--fixed-ae] [--dtype bfloat16] [--tiny] \\
        [--device cuda] [--work-dir DIR]
    python -m objectcentricocccompletion_torch.tools.train sst \\
        --infos data/infos.pkl --data-root data --total-steps 1000 \\
        [--dtype bfloat16] [--tiny] [--device cuda] [--work-dir DIR]
    python -m objectcentricocccompletion_torch.tools.train centerpoint \\
        --infos data/infos.pkl --data-root data --total-steps 1000 \\
        [--tiny] [--device cuda] [--work-dir DIR]
    python -m objectcentricocccompletion_torch.tools.train fsd|fsd2 \\
        --infos data/infos.pkl --data-root data --total-steps 1000 \\
        [--dtype bfloat16] [--tiny] [--device cuda] [--work-dir DIR]

``ococcnet`` / ``ctrl`` build ``OcOccNetConfig()`` (``--tiny``:
``tiny_config()``; ``ctrl``: the CTRL class variant of ``--ctrl-class``),
read the tracklets with ``TrackletDataset`` and train with
``training/trainer.py::train``; ``data/loader.py::write_synthetic_dataset``
writes a dataset in the reference's layout for it. ``sst`` builds
``SSTDetector`` (the full-width ``SSTDetectorConfig()``, or the tiny one
with ``--tiny``), reads the frames with ``FrameDataset`` (``--tiny``: 4096
points and 32 boxes per frame, as the JAX CLI) and trains with
``train_detector``; ``write_synthetic_frames`` (``data/frame_dataset.py``)
writes a production-scale synthetic dataset for it. ``centerpoint`` does
the same with ``DynamicCenterPoint`` (``CenterPointConfig()``, or
``tiny_centerpoint_config()`` with ``--tiny``), float32 end to end: its
``--dtype`` sets ``encoder_dtype`` as the JAX CLI does, which only the
column layout (not ported) reads. ``fsd`` trains the single-stage
``FSD`` (``FSDConfig()``, or ``tiny_fsd_config()``) on ``fsd_loss``,
``fsd2`` the two-stage ``TwoStageFSD`` (``TwoStageFSDConfig()``, or
``tiny_two_stage_config()``) on ``two_stage_loss``; ``--dtype`` sets
their ``compute_dtype``. Weights are drawn from
a ``torch.Generator`` seeded with ``--seed``; everything runs on
``--device`` (``cuda`` unless the caller asks for the CPU). ``--dtype``
sets the compute dtype; parameters stay float32.

The flags of the JAX CLI are kept. Those of options not ported yet (the
``fsdpp`` and ``votenet`` families, other datasets, ``--tp``, ``--fsdp``,
``--sequence-parallel``, ``--loader-workers`` > 0, the multi-host launch,
``--occ-pred-root``, ``--num-sweeps``, ``--augment``,
``--disable-aug-after``, ``--gt-sample``) raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Sequence

import torch

from ..configs.ococcnet_config import (OcOccNetConfig, ctrl_cyc_config,
                                       ctrl_ped_config, ctrl_veh_config,
                                       tiny_config)
from ..data.frame_dataset import FrameDataset
from ..data.tracklet_dataset import TrackletDataset
from ..models.centerpoint import (CenterPointConfig, DynamicCenterPoint,
                                  tiny_centerpoint_config)
from ..models.fsd import FSD, FSDConfig, tiny_fsd_config
from ..models.fsd_two_stage import (TwoStageFSD, TwoStageFSDConfig,
                                    tiny_two_stage_config)
from ..models.sst_detector import (SSTDetector, SSTDetectorConfig,
                                   tiny_sst_detector_config)
from ..training.detector_trainer import train_detector
from ..training.trainer import train
from ..utils.device import resolve_device

FAMILIES = ["ococcnet", "ctrl", "centerpoint", "sst", "fsd", "fsd2",
            "fsdpp", "votenet"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("model", choices=FAMILIES, help="model family to train")
    # tracklet-family inputs (ococcnet / ctrl)
    p.add_argument("--proposals")
    p.add_argument("--gt-candidates")
    p.add_argument("--poses")
    p.add_argument("--occ-root", default=None)
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
    p.add_argument("--ctrl-class", choices=["veh", "ped", "cyc"],
                   default="veh", help="CTRL class variant")
    p.add_argument("--fixed-ae", action="store_true",
                   help="freeze the occupancy auto-encoder")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="compute dtype (parameters stay float32)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size (not ported)")
    p.add_argument("--fsdp", action="store_true",
                   help="sharded parameters and moments (not ported)")
    p.add_argument("--loader-workers", type=int, default=0,
                   help="sample-building worker processes (not ported); 0: "
                        "in-process build with a prefetch thread")
    p.add_argument("--sequence-parallel", action="store_true",
                   help="sharded point / query axes (not ported)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator (not ported)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


def ococc_train_config(model: str = "ococcnet", tiny: bool = False,
                       ctrl_class: str = "veh", fixed_ae: bool = False,
                       dtype: str | None = None) -> OcOccNetConfig:
    """The config the JAX CLI trains for ``model`` (``ococcnet`` or
    ``ctrl``), with the port's ``dtype`` on top."""
    cfg = tiny_config() if tiny else OcOccNetConfig()
    if model == "ctrl":
        base = {"veh": ctrl_veh_config, "ped": ctrl_ped_config,
                "cyc": ctrl_cyc_config}[ctrl_class]()
        cfg = dataclasses.replace(
            cfg, variant="ctrl", class_names=base.class_names,
            cls_pos_thr=base.cls_pos_thr, cls_neg_thr=base.cls_neg_thr,
            corner_loss_weight=base.corner_loss_weight) if tiny else base
    if fixed_ae:
        cfg = dataclasses.replace(cfg, fixed_ae=True)
    if dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return cfg


def _refuse_unported(args: argparse.Namespace) -> None:
    unported = {"--tp": args.tp > 1, "--fsdp": args.fsdp,
                "--sequence-parallel": args.sequence_parallel,
                "--loader-workers": args.loader_workers > 0,
                "the multi-host launch (--coordinator, --num-processes)":
                    args.coordinator is not None
                    or (args.num_processes or 1) > 1}
    for flag, used in unported.items():
        if used:
            raise NotImplementedError(f"{flag} is not ported yet")


def sst_train_config(tiny: bool = False, dtype: str | None = None
                     ) -> SSTDetectorConfig:
    cfg = tiny_sst_detector_config() if tiny else SSTDetectorConfig()
    if dtype:
        cfg = dataclasses.replace(cfg, sst=dataclasses.replace(
            cfg.sst, compute_dtype=dtype))
    return cfg


def centerpoint_train_config(tiny: bool = False, dtype: str | None = None
                             ) -> CenterPointConfig:
    cfg = tiny_centerpoint_config() if tiny else CenterPointConfig()
    if dtype:
        cfg = dataclasses.replace(cfg, encoder_dtype=dtype)
    return cfg


def fsd_train_config(tiny: bool = False, dtype: str | None = None
                     ) -> FSDConfig:
    cfg = tiny_fsd_config() if tiny else FSDConfig()
    if dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return cfg


def fsd2_train_config(tiny: bool = False, dtype: str | None = None
                      ) -> TwoStageFSDConfig:
    """The compute dtype lives on the single-stage sub-config."""
    cfg = tiny_two_stage_config() if tiny else TwoStageFSDConfig()
    return dataclasses.replace(cfg, fsd=fsd_train_config(tiny, dtype))


# family -> (model class, config of (tiny, dtype))
DETECTORS = {
    "sst": (SSTDetector, sst_train_config),
    "centerpoint": (DynamicCenterPoint, centerpoint_train_config),
    "fsd": (FSD, fsd_train_config),
    "fsd2": (TwoStageFSD, fsd2_train_config),
}


def build_detector(family: str, tiny: bool = False, dtype: str | None = None,
                   device="cuda", generator: torch.Generator | None = None):
    """The detector of ``family`` (a key of ``DETECTORS``) that the CLIs
    train and evaluate, on ``device``; weights from ``generator`` when one
    is given. Its ``loss`` is the family's training loss."""
    if family not in DETECTORS:
        raise NotImplementedError(
            f"the {family!r} detector family is not ported yet")
    cls, config = DETECTORS[family]
    return cls(config(tiny, dtype), device=device, generator=generator)


def main(argv=None,
         hooks: Sequence[Callable[[int, dict], None]] = ()) -> int:
    """Run the CLI on ``argv``; ``hooks`` go to the training loop (for a
    caller that drives training from Python). Returns the steps done."""
    args = parse_args(argv)
    _refuse_unported(args)
    if args.model in ("ococcnet", "ctrl"):
        cfg = ococc_train_config(args.model, args.tiny, args.ctrl_class,
                                 args.fixed_ae, args.dtype)
        dev = resolve_device(args.device)
        ds = TrackletDataset(
            proposals_file=args.proposals,
            gt_candidates_file=args.gt_candidates, pose_file=args.poses,
            occ_anno_root=args.occ_root, cfg=cfg,
            class_names=cfg.class_names)
        print(f"dataset: {len(ds)} tracklets", flush=True)
        return train(cfg, ds, args.work_dir, total_steps=args.total_steps,
                     ckpt_interval=args.ckpt_interval,
                     log_interval=args.log_interval, resume=not args.no_resume,
                     seed=args.seed, device=dev, hooks=hooks)
    if args.model not in DETECTORS:
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
    model = build_detector(args.model, args.tiny, args.dtype, dev,
                           torch.Generator().manual_seed(args.seed))
    return train_detector(model, ds, args.work_dir,
                          total_steps=args.total_steps or 1000,
                          ckpt_interval=args.ckpt_interval,
                          log_interval=args.log_interval, seed=args.seed,
                          device=dev, resume=not args.no_resume,
                          hooks=hooks)


if __name__ == "__main__":
    main()
