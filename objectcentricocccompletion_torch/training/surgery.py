"""Checkpoint surgery: publish (strip the optimizer state) and transplant
tensors between state dicts (counterpart of the JAX package's
``training/surgery.py``, itself the counterpart of the reference's
``tools/model_converters/publish_model.py`` and
``fsd_pretrain_converter.py``).

The port's checkpoints are ``step_<N>.pt`` files holding ``{step, model,
optimizer}`` (``training/trainer.py::CheckpointManager``); a published
checkpoint is the same file without ``optimizer``, so ``restore_params``
and ``CheckpointManager.restore`` read either kind.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from ..convert import state_dict_to_flax
from .trainer import CheckpointManager


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _latest(ckpt_dir: str) -> str:
    ckpt_dir = os.path.abspath(ckpt_dir)
    steps = (CheckpointManager(ckpt_dir).steps()
             if os.path.isdir(ckpt_dir) else [])
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{steps[-1]}.pt")


def restore_params(ckpt_dir: str) -> tuple[int, dict]:
    """``(step, state_dict)`` of the newest checkpoint under ``ckpt_dir``:
    a training checkpoint or a published one (no ``optimizer`` entry)."""
    state = torch.load(_latest(ckpt_dir), map_location="cpu",
                       weights_only=True)
    return int(state["step"]), state["model"]


def tree_hash(params: dict) -> str:
    """The content hash of a state dict: path-ordered sha256 over each
    leaf's '/'-joined path, its dtype and shape strings and its raw bytes,
    taken over the flax tree that ``convert.state_dict_to_flax`` gives for
    the weights, so that a checkpoint published by either package gets the
    same name. Every buffer of the port's models (``code_weights``,
    ``extra_wlh``, the SIR normalisers, SST's anchors) is registered
    non-persistent: it is derived from the config, lies in no state dict
    and is not hashed; a persistent buffer would be hashed as a leaf under
    its own name, which no flax tree holds."""
    h = hashlib.sha256()
    for path, leaf in sorted(_flatten(state_dict_to_flax(params)),
                             key=lambda kv: kv[0]):
        h.update("/".join(path).encode())
        arr = np.asarray(leaf)
        h.update(str(arr.dtype).encode() + str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def publish(ckpt_dir: str, out_dir: str, keep_step: bool = True) -> str:
    """Write a params-only checkpoint of the newest one under ``ckpt_dir``
    to ``{out_dir}-{hash8}`` (its step, or 0 without ``keep_step``), copy
    ``config.json`` where one is there, write ``PUBLISH.json`` with the
    ``sha256`` and the ``source_step``; returns the directory."""
    step, params = restore_params(ckpt_dir)
    digest = tree_hash(params)
    out = f"{out_dir.rstrip('/')}-{digest[:8]}"
    os.makedirs(out, exist_ok=True)
    save_params(out, step if keep_step else 0, params)
    cfg_src = os.path.join(ckpt_dir, "config.json")
    if os.path.exists(cfg_src):
        shutil.copy(cfg_src, os.path.join(out, "config.json"))
    with open(os.path.join(out, "PUBLISH.json"), "w") as f:
        json.dump({"sha256": digest, "source_step": step}, f)
    return out


def save_params(ckpt_dir: str, step: int, params: dict) -> str:
    """A checkpoint of ``params`` at ``step`` with no optimizer state, in
    ``CheckpointManager``'s layout; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}.pt")
    torch.save({"step": step, "model": params}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def transplant(dst_params: dict, src_params: dict, src_prefix: str = "",
               dst_prefix: str = "", strict_shapes: bool = True
               ) -> tuple[dict, dict]:
    """Copy every tensor of ``src_params`` whose name starts with
    ``src_prefix`` into ``dst_params`` under the name with ``dst_prefix``
    in its place (the reference's ``fsd_pretrain_converter``: FSD's
    ``vfe.`` / ``unet.`` become CTRL's ``net.segmentor.vfe.`` /
    ``net.segmentor.unet.``). The prefix is a plain string prefix, not a
    name component, as in the JAX package (``vfe`` also takes ``vfe2.``).

    Names are the state dicts' ('.'-joined). Returns ``(new_params,
    report)``: ``copied`` (the target names), ``missing`` (source names
    with no target) and ``shape_mismatch`` ((source name, source shape,
    target shape); copied anyway without ``strict_shapes``).
    ``dst_params`` is not changed."""
    dst = dict(dst_params)
    copied, missing, mismatch = [], [], []
    for name, leaf in src_params.items():
        if src_prefix and not name.startswith(src_prefix):
            continue
        target = dst_prefix + name[len(src_prefix):]
        if target not in dst:
            missing.append(name)
            continue
        if tuple(dst[target].shape) != tuple(leaf.shape):
            mismatch.append((name, tuple(leaf.shape),
                             tuple(dst[target].shape)))
            if strict_shapes:
                continue
        dst[target] = leaf.detach().clone()
        copied.append(target)
    return dst, {"copied": copied, "missing": missing,
                 "shape_mismatch": mismatch}
