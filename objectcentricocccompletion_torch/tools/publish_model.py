"""Checkpoint surgery CLI of the port (counterpart of the JAX repository's
``tools/publish_model.py``):

    # strip the optimizer state and name the artifact by its content hash
    python -m objectcentricocccompletion_torch.tools.publish_model \\
        publish work_dir/ckpt --out release/ococcnet

    # warm-start a tree from a pretrained one (CTRL's segmentor from FSD):
    # copy the source's --src-prefix tensors into the target's --dst-prefix
    # names and write a new checkpoint at step 0 with no optimizer state
    python -m objectcentricocccompletion_torch.tools.publish_model \\
        transplant fsd_work/ckpt ctrl_work/ckpt --out warm/ckpt \\
        --src-prefix vfe. --dst-prefix net.segmentor.vfe.

``tools/train.py`` resumes from the transplanted checkpoint at step 0 with
a fresh AdamW (``CheckpointManager.restore``). Checkpoints are the port's
``step_<N>.pt`` files (``training/trainer.py``).
"""
from __future__ import annotations

import argparse

from ..training.surgery import (publish, restore_params, save_params,
                                transplant)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    pub = sub.add_parser("publish")
    pub.add_argument("ckpt_dir")
    pub.add_argument("--out", required=True)
    tr = sub.add_parser("transplant")
    tr.add_argument("src_ckpt", help="pretrained checkpoint (source tensors)")
    tr.add_argument("dst_ckpt", help="checkpoint providing the target tree")
    tr.add_argument("--out", required=True)
    tr.add_argument("--src-prefix", default="")
    tr.add_argument("--dst-prefix", default="")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Run the CLI on ``argv``; returns the directory written."""
    args = parse_args(argv)
    if args.cmd == "publish":
        out = publish(args.ckpt_dir, args.out)
        print(out)
        return out
    _, src = restore_params(args.src_ckpt)
    _, dst = restore_params(args.dst_ckpt)
    new, report = transplant(dst, src, args.src_prefix, args.dst_prefix)
    print(f"copied {len(report['copied'])} leaves; "
          f"{len(report['missing'])} missing; "
          f"{len(report['shape_mismatch'])} shape mismatches")
    for m in report["missing"][:10]:
        print("  missing:", m)
    for m in report["shape_mismatch"][:10]:
        print("  mismatch:", m)
    save_params(args.out, 0, new)
    print(args.out)
    return args.out


if __name__ == "__main__":
    main()
