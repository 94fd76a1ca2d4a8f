"""Python wrapper around the native Waymo detection-metrics binary
(counterpart of the JAX package's ``evalx/waymo_metrics.py``): run the C++
evaluator on (predictions.bin, gt.bin) and parse its printed mAP / mAPH
table into a dict.

The port builds the binary itself from the shared source,
``native/waymo_metrics/compute_detection_metrics_main.cc``, with ``g++``
into ``build/`` at the repository root (``.gitignore`` lists it), under a
name that carries a digest of the source and the flags, as
``ops/_build.py`` does for the CUDA kernels. It never writes under
``native/``, and a failed build raises.
"""
from __future__ import annotations

import hashlib
import os
import re
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = (ROOT / "native" / "waymo_metrics"
          / "compute_detection_metrics_main.cc")
BUILD_DIR = ROOT / "build"
# native/waymo_metrics/Makefile's flags, and -pthread for the source's
# std::thread
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-pthread")

_LINE = re.compile(r"^(.+): \[mAP ([0-9.eE+-]+)\] \[mAPH ([0-9.eE+-]+)\]$")


def binary_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"compute_detection_metrics_main-{h.hexdigest()[:16]}"


def ensure_built() -> str:
    """The binary's path; compiles it first if this source has no build."""
    out = binary_path()
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the Waymo metrics binary failed "
                           f"(g++ exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return str(out)


def compute_metrics(pred_bin: str, gt_bin: str) -> dict:
    """``{"<breakdown>/mAP": x, "<breakdown>/mAPH": y, ..., "_raw": text}``
    for every line the binary prints in the official format."""
    out = subprocess.check_output([ensure_built(), pred_bin, gt_bin],
                                  text=True)
    metrics = {}
    for line in out.splitlines():
        m = _LINE.match(line.strip())
        if m:
            metrics[f"{m.group(1)}/mAP"] = float(m.group(2))
            metrics[f"{m.group(1)}/mAPH"] = float(m.group(3))
    metrics["_raw"] = out
    return metrics
