"""Training CLI of the port (counterpart of the JAX repository's
``tools/train.py``).

    python -m objectcentricocccompletion_torch.tools.train ococcnet \\
        --proposals data/proposals.pkl --gt-candidates data/cands.pkl \\
        --poses data/poses.pkl --occ-root data/occ_gt --total-steps 1000 \\
        [--ctrl-class veh] [--fixed-ae] [--dtype bfloat16] \\
        [--loader-workers N] [--tiny] [--device cuda] [--work-dir DIR] \\
        [--coordinator HOST:PORT --num-processes N --process-id R \\
         [--dist-backend nccl|gloo] [--tp N] [--fsdp] \\
         [--sequence-parallel]]
    python -m objectcentricocccompletion_torch.tools.train sst \\
        --infos data/infos.pkl --data-root data --total-steps 1000 \\
        [--dtype bfloat16] [--augment] [--gt-sample N] [--num-sweeps N] \\
        [--disable-aug-after STEP] [--tiny] [--device cuda] [--work-dir DIR]
    python -m objectcentricocccompletion_torch.tools.train centerpoint \\
        --infos data/infos.pkl --data-root data --total-steps 1000 \\
        [--tiny] [--device cuda] [--work-dir DIR]
    python -m objectcentricocccompletion_torch.tools.train fsd|fsd2 \\
        --infos data/infos.pkl --data-root data --total-steps 1000 \\
        [--dtype bfloat16] [--tiny] [--device cuda] [--work-dir DIR]
    python -m objectcentricocccompletion_torch.tools.train fsdpp \\
        --infos data/infos.pkl --data-root data --total-steps 1000 \\
        [--seq-window 2] [--tiny] [--device cuda] [--work-dir DIR]
    python -m objectcentricocccompletion_torch.tools.train votenet \\
        --dataset scannet|sunrgbd --infos data/infos.pkl --data-root data \\
        --total-steps 1000 [--tiny] [--device cuda] [--work-dir DIR]

``ococcnet`` / ``ctrl`` build ``OcOccNetConfig()`` (``--tiny``:
``tiny_config()``; ``ctrl``: the CTRL class variant of ``--ctrl-class``),
read the tracklets with ``TrackletDataset`` and train with
``training/trainer.py::train``; ``data/loader.py::write_synthetic_dataset``
writes a dataset in the reference's layout for it. ``--loader-workers N``
builds their samples in N processes (``PrefetchLoader``; the same batches
for any N). ``sst`` builds
``SSTDetector`` (the full-width ``SSTDetectorConfig()``, or the tiny one
with ``--tiny``), reads the frames with ``FrameDataset`` (``--tiny``: 4096
points and 32 boxes per frame, as the JAX CLI) and trains with
``train_detector``; ``write_synthetic_frames`` (``data/frame_dataset.py``)
writes a production-scale synthetic dataset for it. ``centerpoint`` does
the same with ``DynamicCenterPoint`` (``CenterPointConfig()``, or
``tiny_centerpoint_config()`` with ``--tiny``), float32 end to end in the
config's gather layout: its ``--dtype`` sets ``encoder_dtype`` as the JAX
CLI does, the activations of the column layout (``encoder_layout=
"column"``, which neither CLI selects). ``fsd`` trains the single-stage
``FSD`` (``FSDConfig()``, or ``tiny_fsd_config()``) on ``fsd_loss``,
``fsd2`` the two-stage ``TwoStageFSD`` (``TwoStageFSDConfig()``, or
``tiny_two_stage_config()``) on ``two_stage_loss``; ``--dtype`` sets
their ``compute_dtype``. ``fsdpp`` trains FSD++ (``FSDPPConfig()``, or
``tiny_fsdpp_config()``) on windows of ``--seq-window`` consecutive frames
of each segment with ``training/seq_trainer.py::train_fsdpp``, which, as
the JAX CLI's call, logs every 50 steps whatever ``--log-interval`` says.
``votenet`` trains ``VoteNet`` (``VoteNetConfig()`` with the dataset's
classes and, for ``sunrgbd``, yaw; ``--tiny``: ``tiny_votenet_config()``)
on its loss, float32 (``--dtype`` does not apply).
``--dataset`` picks the frame reader of every detector family: ``waymo``
(``FrameDataset``), ``nuscenes`` / ``lyft`` (``data/nuscenes_dataset.py``),
``scannet`` / ``sunrgbd`` (``data/indoor_dataset.py``) or ``argo2``
(``data/argo2_dataset.py``, which needs pandas and pyarrow; ``--data-root``
is the dataset's root and ``--infos`` the split's name, ``train`` by
default). The detector's input width follows the reader's
``point_dim``. The frame pipeline's flags below read Waymo frames: with
another dataset they are ignored, as the JAX CLI ignores them.
``--occ-pred-root`` merges the predicted occupancy points that
``Evaluator.run(save_occ_root=...)`` writes into every frame family's
frames (W8). Every frame family takes the frame training pipeline of
``FrameDataset``: ``--augment`` (flip, rotation, scale), ``--gt-sample N``
(GT copy-paste of N objects per class from a ``GTDatabase`` of the
training frames, cached at ``--gt-db-cache``), ``--num-sweeps N`` (N
earlier sweeps and a time-lag column: the detector's ``point_dim`` becomes
6) and ``--disable-aug-after STEP`` (augmentation and paste off from that
step on). Weights are drawn from
a ``torch.Generator`` seeded with ``--seed``; everything runs on
``--device`` (``cuda`` unless the caller asks for the CPU). ``--dtype``
sets the compute dtype; parameters stay float32.

The multi-process launch (``--coordinator host:port --num-processes N
--process-id R``, one process per card, started by the user on each
rank) trains every family but ``fsdpp`` data-parallel: the global batch is
N times the per-process batch, each rank trains on its slice through
``DistributedDataParallel`` (``parallel/multihost.py``,
``parallel/train.py``, ``training/detector_trainer.py``), and rank 0
writes the checkpoints and ``metrics.jsonl``. Rank R runs on
``cuda:{R % device_count}`` (``--device cpu``: the CPU); the backend is
``nccl`` on the card and ``gloo`` on the CPU, and ``--dist-backend gloo``
serves several ranks on one card. ``fsdpp`` trains on one device, as in
the JAX package.

``ococcnet`` / ``ctrl`` also train model-parallel, as the JAX CLI passes
the flags to the tracklet trainer: ``--tp N`` lays the processes out on a
``[num_processes / N, N]`` data x model mesh and shards the wide Dense
layers over the model axis, ``--fsdp`` shards the large parameters and
their AdamW moments over the data axis (and wins over ``--tp``, whose axis
then serves sequence parallelism only), ``--sequence-parallel`` splits the
packed points and the decoder's queries over the model axis
(``training/trainer.py::train``). One process per card: where the JAX
CLI drives every chip from one process, ``--tp N`` needs a multiple of N
processes, and ``--sequence-parallel`` needs ``--tp`` > 1; both raise
``ValueError`` otherwise.

The flags of the JAX CLI are kept. ``--tp``, ``--fsdp`` and
``--sequence-parallel`` of a detector family, which the JAX CLI accepts and
ignores, raise ``NotImplementedError``, and so do ``--loader-workers`` of a
detector family and a multi-process ``fsdpp``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Sequence

import torch

from ..configs.ococcnet_config import (OcOccNetConfig, ctrl_cyc_config,
                                       ctrl_ped_config, ctrl_veh_config,
                                       tiny_config)
from ..data.argo2_dataset import Argo2Dataset
from ..data.dbsampler import DBSampler, GTDatabase
from ..data.frame_dataset import FrameDataset
from ..data.indoor_dataset import ScanNetDataset, SUNRGBDDataset
from ..data.nuscenes_dataset import LyftDataset, NuScenesDataset
from ..data.tracklet_dataset import TrackletDataset
from ..models.centerpoint import (CenterPointConfig, DynamicCenterPoint,
                                  tiny_centerpoint_config)
from ..models.fsd import FSD, FSDConfig, tiny_fsd_config
from ..models.fsd_two_stage import (TwoStageFSD, TwoStageFSDConfig,
                                    tiny_two_stage_config)
from ..models.fsdpp import FSDPP, FSDPPConfig, tiny_fsdpp_config
from ..models.sst_detector import (SSTDetector, SSTDetectorConfig,
                                   tiny_sst_detector_config)
from ..models.votenet import VoteNet, VoteNetConfig, tiny_votenet_config
from ..parallel import multihost
from ..training.detector_trainer import train_detector
from ..training.seq_trainer import train_fsdpp
from ..training.trainer import train

FAMILIES = ["ococcnet", "ctrl", "centerpoint", "sst", "fsd", "fsd2",
            "fsdpp", "votenet"]
DATASETS = ["waymo", "argo2", "nuscenes", "lyft", "scannet", "sunrgbd"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("model", choices=FAMILIES, help="model family to train")
    # tracklet-family inputs (ococcnet / ctrl)
    p.add_argument("--proposals")
    p.add_argument("--gt-candidates")
    p.add_argument("--poses")
    p.add_argument("--occ-root", default=None)
    p.add_argument("--infos", help="frame infos pkl")
    p.add_argument("--dataset", choices=DATASETS, default="waymo",
                   help="frame dataset family")
    p.add_argument("--data-root", help="frame data root")
    p.add_argument("--occ-pred-root", default=None,
                   help="merge predicted occupancy points (W8)")
    p.add_argument("--work-dir", default="work_dirs/run")
    p.add_argument("--total-steps", type=int, default=None)
    p.add_argument("--ckpt-interval", type=int, default=1000)
    p.add_argument("--log-interval", type=int, default=50,
                   help="metrics.jsonl cadence (steps)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="tiny config for smoke runs")
    p.add_argument("--seq-window", type=int, default=2,
                   help="frames per window (fsdpp)")
    p.add_argument("--num-sweeps", type=int, default=0,
                   help="concatenate N earlier sweeps into each frame (adds "
                        "a time-lag point column)")
    p.add_argument("--augment", action="store_true",
                   help="frame geometry augmentation (flip, rotation, "
                        "scale)")
    p.add_argument("--disable-aug-after", type=int, default=None,
                   help="turn augmentation and GT paste off from this step "
                        "on")
    p.add_argument("--gt-sample", type=int, default=0,
                   help="GT copy-paste augmentation: target objects per "
                        "class per frame (0 = off)")
    p.add_argument("--gt-db-cache", default=None,
                   help="pickle cache of the GT copy-paste database")
    p.add_argument("--gt-db-min-points", type=int, default=8,
                   help="least interior points of a GT crop in the "
                        "database")
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
                   help="ococcnet / ctrl: model axis size (tensor "
                        "parallelism); needs a multiple of N processes")
    p.add_argument("--fsdp", action="store_true",
                   help="ococcnet / ctrl: shard the large parameters and "
                        "their AdamW moments over the data axis")
    p.add_argument("--loader-workers", type=int, default=0,
                   help="ococcnet / ctrl: sample-building worker processes; "
                        "0: in-process build with a prefetch thread")
    p.add_argument("--sequence-parallel", action="store_true",
                   help="ococcnet / ctrl: split the packed points and the "
                        "occupancy queries over the model axis (--tp > 1)")
    # the multi-process launch: one process per card, each started with
    # its own --process-id
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 for a multi-process run")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="collective backend (default: nccl on the card, "
                        "gloo on the CPU; gloo serves several ranks on one "
                        "card)")
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
    detector = args.model not in ("ococcnet", "ctrl")
    tracklet_only = {"--tp": args.tp > 1, "--fsdp": args.fsdp,
                     "--sequence-parallel": args.sequence_parallel}
    for flag, used in tracklet_only.items():
        if used and detector:
            raise NotImplementedError(
                f"{flag} trains ococcnet / ctrl only: the JAX CLI passes it "
                f"to the tracklet trainer and ignores it for {args.model}")
    unported = {"--loader-workers of a detector family":
                    args.loader_workers > 0 and detector,
                "--num-processes of fsdpp (one device, as in the JAX "
                "package)": args.model == "fsdpp"
                    and (args.num_processes or 1) > 1}
    for flag, used in unported.items():
        if used:
            raise NotImplementedError(f"{flag} is not ported yet")


def _check_model_parallel(args: argparse.Namespace) -> None:
    """The model-parallel flags' usage errors, before any process joins."""
    n = args.num_processes or 1
    if args.sequence_parallel and args.tp <= 1:
        raise ValueError("--sequence-parallel needs a model axis: --tp > 1")
    if args.tp < 1 or n % args.tp:
        raise ValueError(f"--tp {args.tp} needs a multiple of {args.tp} "
                         f"processes, not --num-processes {n}: one process "
                         f"per card, each rank of a model group in a "
                         f"process of its own")


def sst_train_config(tiny: bool = False, dtype: str | None = None
                     ) -> SSTDetectorConfig:
    cfg = tiny_sst_detector_config() if tiny else SSTDetectorConfig()
    if dtype:
        cfg = dataclasses.replace(cfg, sst=dataclasses.replace(
            cfg.sst, compute_dtype=dtype))
    return cfg


def centerpoint_train_config(tiny: bool = False, dtype: str | None = None,
                             encoder_layout: str = "gather"
                             ) -> CenterPointConfig:
    """``encoder_layout``: the sparse encoder's layout (no CLI flag selects
    it, as in the JAX CLIs; ``tools/benchmark.py --encoder-layout``)."""
    cfg = tiny_centerpoint_config() if tiny else CenterPointConfig()
    cfg = dataclasses.replace(cfg, encoder_layout=encoder_layout)
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


def fsdpp_train_config(tiny: bool = False, dtype: str | None = None
                       ) -> FSDPPConfig:
    """The compute dtype lives on the single-stage sub-config."""
    cfg = tiny_fsdpp_config() if tiny else FSDPPConfig()
    return dataclasses.replace(cfg, fsd=fsd_train_config(tiny, dtype))


def votenet_train_config(tiny: bool = False, dtype: str | None = None,
                         num_classes: int = 18, with_yaw: bool = False
                         ) -> VoteNetConfig:
    """VoteNet for ``num_classes`` classes (float32; ``dtype`` does not
    apply, as in the JAX CLI)."""
    if tiny:
        return tiny_votenet_config(min(num_classes, 4))
    return VoteNetConfig(num_classes=num_classes, with_yaw=with_yaw)


def with_point_dim(cfg, point_dim: int):
    """``cfg`` with points ``point_dim`` wide (on the sub-config that holds
    the VFE: ``sst`` of SST, ``fsd`` of the two-stage families; VoteNet
    reads at most ``in_feats`` columns after xyz)."""
    if isinstance(cfg, VoteNetConfig):
        return dataclasses.replace(cfg,
                                   in_feats=min(cfg.in_feats, point_dim - 3))
    for sub in ("sst", "fsd"):
        if hasattr(cfg, sub):
            return dataclasses.replace(cfg, **{sub: dataclasses.replace(
                getattr(cfg, sub), point_dim=point_dim)})
    return dataclasses.replace(cfg, point_dim=point_dim)


# family -> (model class, config of (tiny, dtype))
DETECTORS = {
    "sst": (SSTDetector, sst_train_config),
    "centerpoint": (DynamicCenterPoint, centerpoint_train_config),
    "fsd": (FSD, fsd_train_config),
    "fsd2": (TwoStageFSD, fsd2_train_config),
    "fsdpp": (FSDPP, fsdpp_train_config),
    "votenet": (VoteNet, votenet_train_config),
}


def build_detector(family: str, tiny: bool = False, dtype: str | None = None,
                   device="cuda", generator: torch.Generator | None = None,
                   point_dim: int = 5, **config_kw):
    """The detector of ``family`` (a key of ``DETECTORS``) that the CLIs
    train and evaluate, for points ``point_dim`` wide (the reader's
    ``point_dim``), on ``device``; weights from ``generator`` when one is
    given. ``config_kw`` go to the family's config function
    (``detector_config_kw``). Its ``loss`` is the family's training loss."""
    cls, config = DETECTORS[family]
    return cls(with_point_dim(config(tiny, dtype, **config_kw), point_dim),
               device=device, generator=generator)


def detector_config_kw(family: str, ds, dataset: str) -> dict:
    """VoteNet's classes (the reader's, 18 where it has none) and its yaw
    (``sunrgbd``), as the JAX CLIs set them; nothing for the other
    families."""
    if family != "votenet":
        return {}
    return dict(num_classes=len(getattr(ds, "classes", range(18))),
                with_yaw=dataset == "sunrgbd")


def frame_dataset(dataset: str, infos: str | None, data_root: str,
                  tiny: bool = False, **waymo_kw):
    """The frame reader of ``dataset`` (``--tiny``: 4096 points and 32
    boxes per frame); ``waymo_kw`` (the frame pipeline's options) go to
    ``FrameDataset`` only. For ``argo2`` ``data_root`` is the dataset's
    root and ``infos`` the split's name."""
    frame_kw = dict(max_points=4096, max_gt=32) if tiny else {}
    if dataset == "waymo":
        return FrameDataset(infos, data_root, **waymo_kw, **frame_kw)
    if dataset == "argo2":
        return Argo2Dataset(data_root, infos or "train", **frame_kw)
    cls = {"nuscenes": NuScenesDataset, "lyft": LyftDataset,
           "scannet": ScanNetDataset, "sunrgbd": SUNRGBDDataset}[dataset]
    return cls(infos, data_root, **frame_kw)


def attach_gt_sampler(ds: FrameDataset, gt_sample: int,
                      cache: str | None = None, min_points: int = 8,
                      seed: int = 0) -> GTDatabase:
    """GT copy-paste on ``ds``, as the JAX CLI sets it up: a database of
    the crops of up to 2,000 of its frames (loaded from ``cache`` where it
    exists, else built and saved there), ``gt_sample`` objects per class."""
    db = GTDatabase.build_or_load(ds, cache_path=cache,
                                  min_points=min_points, max_frames=2000)
    ds.db_sampler = DBSampler(db, {lab: gt_sample for lab in db.entries},
                              seed=seed)
    print(f"gt database: {len(db)} crops, classes {sorted(db.entries)}",
          flush=True)
    return db


def main(argv=None,
         hooks: Sequence[Callable[[int, dict], None]] = ()) -> int:
    """Run the CLI on ``argv``; ``hooks`` go to the training loop (for a
    caller that drives training from Python). Returns the steps done. A
    process group that this call joined is left at the end; one that the
    caller set up stays up."""
    args = parse_args(argv)
    _refuse_unported(args)
    _check_model_parallel(args)
    dev = multihost.initialize(args.coordinator, args.num_processes,
                               args.process_id, args.dist_backend,
                               args.device)
    joined = (args.num_processes or 1) > 1
    try:
        return _train(args, dev, hooks)
    finally:
        if joined:
            multihost.shutdown()


def _train(args: argparse.Namespace, dev: torch.device,
           hooks: Sequence[Callable[[int, dict], None]]) -> int:
    if args.model in ("ococcnet", "ctrl"):
        cfg = ococc_train_config(args.model, args.tiny, args.ctrl_class,
                                 args.fixed_ae, args.dtype)
        ds = TrackletDataset(
            proposals_file=args.proposals,
            gt_candidates_file=args.gt_candidates, pose_file=args.poses,
            occ_anno_root=args.occ_root, cfg=cfg,
            class_names=cfg.class_names)
        print(f"dataset: {len(ds)} tracklets", flush=True)
        return train(cfg, ds, args.work_dir, total_steps=args.total_steps,
                     ckpt_interval=args.ckpt_interval,
                     log_interval=args.log_interval, resume=not args.no_resume,
                     seed=args.seed, device=dev, hooks=hooks,
                     loader_workers=args.loader_workers, tp=args.tp,
                     fsdp=args.fsdp,
                     sequence_parallel=args.sequence_parallel)
    if not args.data_root or not (args.infos or args.dataset == "argo2"):
        raise SystemExit(
            f"{args.model} training needs --infos and --data-root")
    if args.model == "fsdpp" and args.dataset != "waymo":
        raise SystemExit("fsdpp trains on the segments of Waymo frames")
    ds = frame_dataset(args.dataset, args.infos, args.data_root, args.tiny,
                       occ_pred_root=args.occ_pred_root,
                       augment=args.augment, num_sweeps=args.num_sweeps)
    print(f"dataset: {len(ds)} frames", flush=True)
    if args.dataset != "waymo":
        ignored = [flag for flag, used in (
            ("--augment", args.augment), ("--gt-sample", args.gt_sample),
            ("--num-sweeps", args.num_sweeps),
            ("--occ-pred-root", args.occ_pred_root),
            ("--disable-aug-after", args.disable_aug_after is not None))
            if used]
        if ignored:
            print(f"{' '.join(ignored)}: Waymo frames only, ignored for "
                  f"--dataset {args.dataset}", flush=True)
    elif args.gt_sample > 0:
        attach_gt_sampler(ds, args.gt_sample, args.gt_db_cache,
                          args.gt_db_min_points, args.seed)
    model = build_detector(args.model, args.tiny, args.dtype, dev,
                           torch.Generator().manual_seed(args.seed),
                           point_dim=ds.point_dim,
                           **detector_config_kw(args.model, ds,
                                                args.dataset))
    if args.model == "fsdpp":
        return train_fsdpp(model, ds, args.work_dir,
                           total_steps=args.total_steps or 1000,
                           window=args.seq_window,
                           ckpt_interval=args.ckpt_interval, seed=args.seed,
                           resume=not args.no_resume, device=dev,
                           hooks=hooks,
                           disable_aug_after=args.disable_aug_after)
    return train_detector(model, ds, args.work_dir,
                          total_steps=args.total_steps or 1000,
                          ckpt_interval=args.ckpt_interval,
                          log_interval=args.log_interval, seed=args.seed,
                          device=dev, resume=not args.no_resume,
                          hooks=hooks,
                          disable_aug_after=args.disable_aug_after)


if __name__ == "__main__":
    main()
