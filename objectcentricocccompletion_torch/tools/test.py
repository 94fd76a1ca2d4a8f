"""Evaluation CLI of the port (counterpart of the JAX repository's
``tools/test.py``; every family but ``votenet``).

    python -m objectcentricocccompletion_torch.tools.test ococcnet \\
        --proposals data/proposals.pkl --gt-candidates data/cands.pkl \\
        --poses data/poses.pkl --occ-root data/occ_gt \\
        --ckpt-dir work_dirs/run/ckpt --out-dir work_dirs/eval \\
        [--ctrl-class veh] [--occ-baseline] [--tta] [--tune-steps N] \\
        [--no-occ] [--max-tracklets N] [--eval-layout dense|packed] \\
        [--tiny] [--device cuda]
    python -m objectcentricocccompletion_torch.tools.test \\
        sst|centerpoint|fsd|fsd2|fsdpp \\
        --infos data/infos.pkl --data-root data \\
        --ckpt-dir work_dirs/sst/ckpt [--metric kitti|waymo] \\
        [--score-thresh 0.1] [--max-frames N] [--out-dir DIR] [--tiny] \\
        [--device cuda]

``ococcnet`` / ``ctrl`` restore the newest checkpoint that ``tools/train.py
ococcnet`` / ``ctrl`` wrote into ``--ckpt-dir``, run ``evalx/evaluator.py``
over the test tracklets (every tracklet of at least one frame), write
``results.bin`` and ``gt.bin`` into ``--out-dir``, score them with the
native Waymo metrics and, for ``ococcnet``, the occupancy IoU (``ctrl`` has
no occupancy decoder). ``--eval-layout`` defaults to ``dense``.
``sst`` / ``centerpoint`` / ``fsd`` / ``fsd2`` restore ``tools/train.py``'s
checkpoint of the family and report KITTI AP (class ``Car``; CenterPoint's
9-dof boxes are cut to 7) or the native Waymo mAP / mAPH over the frames
of ``--infos``; ``fsdpp`` walks each segment's frames in time order with
its memory carried (``evaluate_detector_sequential``, which, as the JAX
function, scores stage 1's boxes). The metrics are printed as JSON.
Everything runs on ``--device`` (``cuda`` unless the caller asks for the
CPU).

``--num-sweeps N`` reads N earlier sweeps into each frame, with the
time-lag column (the detector's ``point_dim`` 6), as training did.

The flags of the JAX CLI are kept (``--device`` replaces ``--cpu``). Those
of options not ported yet (the ``votenet`` family, other datasets) raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from ..data.frame_dataset import CLASS_MAP, FrameDataset
from ..data.tracklet_dataset import TrackletDataset
from ..evalx.detector_eval import (evaluate_detector,
                                  evaluate_detector_sequential,
                                  evaluate_detector_waymo)
from ..evalx.evaluator import Evaluator
from ..models.ococcnet import OcOccNetWithLoss
from ..training.trainer import CheckpointManager
from ..utils.device import resolve_device
from .train import (DETECTORS, FAMILIES, build_detector,
                    ococc_train_config)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("model", choices=FAMILIES, help="model family")
    p.add_argument("--ctrl-class", choices=["veh", "ped", "cyc"],
                   default="veh", help="CTRL class variant")
    # tracklet-family inputs (ococcnet / ctrl)
    p.add_argument("--proposals")
    p.add_argument("--gt-candidates")
    p.add_argument("--poses")
    p.add_argument("--occ-root", default=None)
    # frame-family inputs (the detectors)
    p.add_argument("--infos", help="frame infos pkl")
    p.add_argument("--dataset", choices=["waymo", "argo2", "nuscenes",
                                         "lyft", "scannet", "sunrgbd"],
                   default="waymo", help="frame dataset family")
    p.add_argument("--data-root", help="frame data root")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--score-thresh", type=float, default=0.1)
    p.add_argument("--metric", choices=["kitti", "waymo"], default="kitti",
                   help="detector metric (waymo: the native mAP / mAPH "
                        "over .bin files)")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out-dir", default="work_dirs/eval")
    p.add_argument("--max-tracklets", type=int, default=None)
    p.add_argument("--no-occ", action="store_true")
    p.add_argument("--occ-baseline", action="store_true",
                   help="also score the point-aggregation occupancy "
                        "baseline beside the model")
    p.add_argument("--tta", action="store_true",
                   help="double-flip test-time augmentation")
    p.add_argument("--tune-steps", type=int, default=0,
                   help="online test-time latent tuning iterations")
    p.add_argument("--num-sweeps", type=int, default=0,
                   help="concatenate N earlier sweeps into each frame, as "
                        "in training")
    p.add_argument("--tiny", action="store_true",
                   help="tiny config for smoke runs")
    p.add_argument("--eval-layout", choices=["dense", "packed"],
                   default="dense",
                   help="point layout of the eval forward (the weights do "
                        "not depend on it)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def _restore(model, ckpt_dir: str) -> None:
    if CheckpointManager(ckpt_dir).restore(model) is None:
        raise SystemExit(f"no checkpoint found in {ckpt_dir}")


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; prints the metrics as JSON and returns
    them."""
    args = parse_args(argv)
    if args.model in ("ococcnet", "ctrl"):
        metrics = _eval_tracklets(args)
    elif args.model in DETECTORS:
        metrics = _eval_detector(args)
    else:
        raise NotImplementedError(
            f"evaluation of the {args.model!r} family is not ported yet")
    print(json.dumps(metrics, indent=2, default=float), flush=True)
    return metrics


def _eval_tracklets(args) -> dict:
    cfg = ococc_train_config(args.model, args.tiny, args.ctrl_class)
    if args.model == "ctrl":
        args.no_occ = True      # no occupancy decoder in the CTRL variant
    if args.eval_layout == "dense":
        cfg = dataclasses.replace(cfg, packed_point_budget=None)
    dev = resolve_device(args.device)
    ds = TrackletDataset(
        proposals_file=args.proposals,
        gt_candidates_file=args.gt_candidates, pose_file=args.poses,
        occ_anno_root=args.occ_root, cfg=cfg, class_names=cfg.class_names,
        training=False, min_tracklet_length=1)
    print(f"dataset: {len(ds)} tracklets", flush=True)
    model = OcOccNetWithLoss(cfg, device=dev)
    _restore(model, args.ckpt_dir)
    ev = Evaluator(model, ds, cfg, tta=args.tta,
                   online_tuning_iters=args.tune_steps, device=dev)
    return ev.run(args.out_dir, max_tracklets=args.max_tracklets,
                  eval_occ=not args.no_occ,
                  eval_occ_baseline=args.occ_baseline)


def _eval_detector(args) -> dict:
    if args.dataset != "waymo":
        raise NotImplementedError(
            f"the {args.dataset!r} dataset is not ported yet")
    if not args.infos or not args.data_root:
        raise SystemExit(
            f"{args.model} evaluation needs --infos and --data-root")
    dev = resolve_device(args.device)
    frame_kw = dict(max_points=4096, max_gt=32) if args.tiny else {}
    ds = FrameDataset(args.infos, args.data_root,
                      num_sweeps=args.num_sweeps, **frame_kw)
    print(f"dataset: {len(ds)} frames", flush=True)
    model = build_detector(args.model, args.tiny, device=dev,
                           point_dim=ds.point_dim)
    _restore(model, args.ckpt_dir)
    model.eval()
    # every class of the frames' labels, so that no GT label falls outside
    # the list of the Waymo files
    every_class = tuple(sorted(CLASS_MAP, key=CLASS_MAP.get))
    if args.model == "fsdpp":
        return evaluate_detector_sequential(
            model, ds, classes=every_class if args.metric == "waymo"
            else ("Car",), score_thresh=args.score_thresh,
            max_frames=args.max_frames, metric=args.metric,
            out_dir=args.out_dir)
    if args.metric == "waymo":
        return evaluate_detector_waymo(
            model, args.model, ds, args.out_dir, classes=every_class,
            score_thresh=args.score_thresh, max_frames=args.max_frames)
    return evaluate_detector(model, args.model, ds,
                             score_thresh=args.score_thresh,
                             max_frames=args.max_frames)


if __name__ == "__main__":
    main()
