"""Data-prep CLI of the port (counterpart of the JAX repository's
``tools/create_data.py``).

    python -m objectcentricocccompletion_torch.tools.create_data waymo_raw \\
        --tfrecord-dir DIR --out-dir RAW
    python -m objectcentricocccompletion_torch.tools.create_data tracklets \\
        --pred-bin pred.bin --gt-bin gt.bin --infos infos.pkl \\
        --data-root ROOT --out-dir OUT
    python -m objectcentricocccompletion_torch.tools.create_data \\
        occ_annotate --gt-bin gt.bin --infos infos.pkl --data-root ROOT \\
        --raw-root RAW --out-dir OCC [--workers N] [--device cuda]
    python -m objectcentricocccompletion_torch.tools.create_data \\
        fsdpp_seeds --results-bin results.bin --out seeds.pkl

``waymo_raw``: tfrecords -> per-frame raw pkls for the annotator (host
only; no tensorflow). ``tracklets``: detection / tracking ``.bin`` results
and KITTI-format frames -> the tracklet dataset (``proposals.pkl``,
``gt_candidates.pkl``, ``poses.pkl``, point npys) that OcOccNet and CTRL
train on. ``occ_annotate``: GT tracklet ``.bin`` and raw frame pkls
(``<raw-root>/<segment>/<ts>.pkl``) -> per-tracklet occupancy npz, the
visibility test on ``--device`` (``cuda`` unless the caller asks for the
CPU); ``--workers N`` re-runs this CLI in N processes, each on a shard of
the segments. ``fsdpp_seeds``: base-detector results -> the FSD++ seed
store.
"""
from __future__ import annotations

import argparse
import os
import pickle
import subprocess
import sys

import numpy as np

from ..data.seed_store import SeedStore
from ..tools_ctrl.generate_tracklets import (tracklets_from_bin,
                                             write_tracklet_dataset)
from ..tools_occ import waymo_raw_converter as wrc
from ..tools_occ.annotate import OccAnnotator
from .create_submission import frame_points_getter


def cmd_tracklets(args) -> dict:
    get_points = frame_points_getter(args.infos, args.data_root)
    with open(args.infos, "rb") as f:
        infos = pickle.load(f)
    poses = {}
    for info in infos:
        ts = int(info.get("timestamp", 0))
        pose = info.get("pose")
        # infos without ego poses (single-log exports): identity, every
        # frame already shares one world frame
        poses[ts] = (np.asarray(pose, np.float64) if pose is not None
                     else np.eye(4))
    paths = write_tracklet_dataset(args.pred_bin, args.gt_bin, get_points,
                                   args.out_dir, poses)
    print(dict(paths), flush=True)
    return paths


def _annotate_shards(args) -> None:
    """The host pool over segments (the reference's worker pool,
    ``tools/occ/occ_annotate.py:649-671``): this CLI once per shard, in
    parallel; the outputs are per-tracklet files, so shards never
    collide."""
    base = [sys.executable, "-m",
            "objectcentricocccompletion_torch.tools.create_data",
            "occ_annotate", "--gt-bin", args.gt_bin, "--infos", args.infos,
            "--data-root", args.data_root, "--raw-root", args.raw_root,
            "--out-dir", args.out_dir, "--voxel-size", str(args.voxel_size),
            "--min-track-len", str(args.min_track_len), "--workers", "1",
            "--num-shards", str(args.workers), "--device", args.device]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(base + ["--shard", str(i)], env=env)
             for i in range(args.workers)]
    try:
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise SystemExit(f"annotation shard failed: {rcs}")


def cmd_occ_annotate(args) -> int:
    """Annotates the GT tracklets of ``--gt-bin`` (this process's shard of
    the segments); returns the number of npz files written or found."""
    if args.workers > 1:
        _annotate_shards(args)
        return 0
    get_points = frame_points_getter(args.infos, args.data_root)
    segment = [""]

    def get_raw_frame(ts):
        path = os.path.join(args.raw_root, segment[0], f"{int(ts)}.pkl")
        with open(path, "rb") as f:
            return pickle.load(f)

    tracklets = tracklets_from_bin(args.gt_bin)
    if args.num_shards > 1:
        segs = sorted({t.segment_name for t in tracklets})
        mine = {s for i, s in enumerate(segs)
                if i % args.num_shards == args.shard}
        tracklets = [t for t in tracklets if t.segment_name in mine]
    ann = OccAnnotator(lambda ts: get_points(segment[0], ts), get_raw_frame,
                       args.out_dir, voxel_size=args.voxel_size,
                       min_track_len=args.min_track_len, device=args.device)
    n_done = 0
    for trk in tracklets:
        segment[0] = trk.segment_name
        out = ann.annotate_trk(trk.segment_name, trk.id,
                               np.asarray(trk.boxes), list(trk.ts))
        n_done += out is not None
    print(f"annotated {n_done}/{len(tracklets)} tracklets -> "
          f"{args.out_dir}", flush=True)
    return n_done


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("waymo_raw", help="tfrecords -> raw frame pkls")
    pr.add_argument("--tfrecord-dir", required=True)
    pr.add_argument("--out-dir", required=True)

    pt = sub.add_parser("tracklets",
                        help=".bin results -> tracklet train data")
    pt.add_argument("--pred-bin", required=True)
    pt.add_argument("--gt-bin", required=True)
    pt.add_argument("--infos", required=True,
                    help="KITTI-format infos pkl (frame points + poses)")
    pt.add_argument("--data-root", required=True)
    pt.add_argument("--out-dir", required=True)

    po = sub.add_parser("occ_annotate",
                        help="GT tracklet .bin + raw pkls -> occ GT npz")
    po.add_argument("--gt-bin", required=True)
    po.add_argument("--infos", required=True)
    po.add_argument("--data-root", required=True)
    po.add_argument("--raw-root", required=True,
                    help="waymo_raw output: <segment>/<ts>.pkl")
    po.add_argument("--out-dir", required=True)
    po.add_argument("--voxel-size", type=float, default=0.2)
    po.add_argument("--min-track-len", type=int, default=10)
    po.add_argument("--workers", type=int, default=1,
                    help="processes, each on a shard of the segments")
    po.add_argument("--shard", type=int, default=0)
    po.add_argument("--num-shards", type=int, default=1)
    po.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")

    ps = sub.add_parser(
        "fsdpp_seeds",
        help="base-detector results .bin -> per-frame FSD++ seed store")
    ps.add_argument("--results-bin", required=True)
    ps.add_argument("--out", required=True, help="seed store pkl path")
    ps.add_argument("--max-seeds", type=int, default=128)
    ps.add_argument("--score-thr", type=float, default=0.1)
    return p.parse_args(argv)


def main(argv=None):
    """Run the CLI on ``argv``; returns the subcommand's result."""
    args = parse_args(argv)
    if args.cmd == "fsdpp_seeds":
        store = SeedStore.from_results_bin(
            args.results_bin, max_seeds=args.max_seeds,
            score_thr=args.score_thr)
        store.save(args.out)
        n = sum(len(v) for v in store.frames.values())
        print(f"{len(store.frames)} frames, {n} seed boxes -> {args.out}",
              flush=True)
        return store
    if args.cmd == "waymo_raw":
        records = sorted(f for f in os.listdir(args.tfrecord_dir)
                         if "tfrecord" in f)
        if not records:
            raise SystemExit(f"no tfrecords in {args.tfrecord_dir}")
        return sum(wrc.convert_segment(os.path.join(args.tfrecord_dir, r),
                                       args.out_dir, f"{i:04d}")
                   for i, r in enumerate(records))
    if args.cmd == "tracklets":
        return cmd_tracklets(args)
    return cmd_occ_annotate(args)


if __name__ == "__main__":
    main()
