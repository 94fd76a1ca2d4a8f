"""Package a results ``.bin`` into a Waymo leaderboard submission
(counterpart of the JAX repository's ``tools/create_submission.py``; host
only, no device):

    python -m objectcentricocccompletion_torch.tools.create_submission \\
        results.bin --out-dir sub --method-name my_method \\
        [--account me@example.com] [--authors "A. Author,B. Author"] \\
        [--affiliation Lab] [--tracking] [--num-shards 4] \\
        [--remove-empty --infos infos.pkl --data-root data]

Writes ``sub/{prefix}0..N-1`` Submission protos and ``sub/{prefix}.tar.gz``;
``--remove-empty`` first drops the predictions whose box holds fewer than
``--min-points`` LiDAR points of their frame (found through kitti-format
infos).
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..evalx.submission import (SubmissionMeta, TASK_DETECTION_3D,
                                TASK_TRACKING_3D, create_submission,
                                remove_empty_predictions)


def frame_points_getter(infos_path: str, data_root: str):
    """``(segment, ts) -> [N, 5]`` ego points of the frame, found through
    kitti-format infos (empty where no frame matches)."""
    with open(infos_path, "rb") as f:
        infos = pickle.load(f)
    index = {}
    for info in infos:
        seg = info.get("segment_name",
                       info["point_cloud"].get("segment_name", ""))
        index[(seg, int(info.get("timestamp", 0)))] = \
            info["point_cloud"]["velodyne_path"]

    def get_points(segment, ts):
        vp = index.get((segment, int(ts)))
        if vp is None:
            return np.zeros((0, 5), np.float32)
        return np.fromfile(os.path.join(data_root, vp),
                           np.float32).reshape(-1, 6)[:, :5]

    return get_points


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("bin", help="results .bin (serialized Objects)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--prefix", default="submission")
    p.add_argument("--method-name", required=True)
    p.add_argument("--account", default="")
    p.add_argument("--authors", default="", help="comma-separated")
    p.add_argument("--affiliation", default="")
    p.add_argument("--description", default="")
    p.add_argument("--method-link", default="")
    p.add_argument("--tracking", action="store_true",
                   help="TRACKING_3D task (default DETECTION_3D)")
    p.add_argument("--num-shards", type=int, default=4)
    p.add_argument("--past-frames", type=int, default=0)
    p.add_argument("--future-frames", type=int, default=0)
    p.add_argument("--latency", type=float, default=0.0)
    p.add_argument("--remove-empty", action="store_true",
                   help="drop predictions whose box holds no LiDAR point")
    p.add_argument("--infos", default=None,
                   help="kitti-format infos pkl resolving (segment, ts) -> "
                        "point file, for --remove-empty")
    p.add_argument("--data-root", default=".")
    p.add_argument("--min-points", type=int, default=1)
    return p.parse_args(argv)


def main(argv=None) -> list[str]:
    """Run the CLI on ``argv``; prints and returns the written paths."""
    args = parse_args(argv)
    bin_path = args.bin
    if args.remove_empty:
        if not args.infos:
            raise SystemExit("--remove-empty needs --infos")
        os.makedirs(args.out_dir, exist_ok=True)
        filtered = os.path.join(args.out_dir,
                                "nonempty_" + os.path.basename(args.bin))
        kept, total = remove_empty_predictions(
            args.bin, filtered, frame_points_getter(args.infos,
                                                    args.data_root),
            min_points=args.min_points)
        print(f"remove-empty: kept {kept}/{total} predictions -> {filtered}")
        bin_path = filtered

    meta = SubmissionMeta(
        unique_method_name=args.method_name, account_name=args.account,
        authors=[a.strip() for a in args.authors.split(",") if a.strip()],
        affiliation=args.affiliation, description=args.description,
        method_link=args.method_link,
        task=TASK_TRACKING_3D if args.tracking else TASK_DETECTION_3D,
        num_past_frames=args.past_frames,
        num_future_frames=args.future_frames, latency_second=args.latency)
    paths = create_submission(bin_path, args.out_dir, args.prefix, meta,
                              num_shards=args.num_shards)
    for pth in paths:
        print(pth)
    return paths


if __name__ == "__main__":
    main()
