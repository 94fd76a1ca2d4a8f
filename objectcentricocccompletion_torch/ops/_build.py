"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under ``build/``
at the repository root (``.gitignore`` lists it) and loaded with ``ctypes``.
The library's file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt. Every source
is compiled by its own ``nvcc`` process, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (argtypes, restype) of each library's C entry points: the float32
# (3xTF32) and the bf16 tensor-core kernels
_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SIGNATURES = {
    "window_attention": {"window_attention_fwd": (_FWD_ARGS, ctypes.c_int)},
    "window_attention_bwd": {
        "window_attention_bwd": (_BWD_ARGS, ctypes.c_int)},
    "window_attention_tc": {
        "window_attention_tc_fwd": (_FWD_ARGS, ctypes.c_int)},
    "window_attention_bwd_tc": {
        "window_attention_tc_bwd": (_BWD_ARGS, ctypes.c_int)},
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH); the "
                           "port's CUDA kernels are built at first use")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every shared
    header in ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every source in ``names`` (default: all of ``csrc/``) that
    is not built yet, one ``nvcc`` each, in parallel. Returns each built
    source's compiler log (``-Xptxas -v``: registers, shared memory,
    spills) and raises on any failure."""
    names = sorted(_SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    logs, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        logs[name] = f"{time.perf_counter() - t0:.1f} s\n{log}"
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` with its entry points' types declared;
    builds it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
