"""Serving export: the OcOccNet inference step as a self-contained artifact
(counterpart of the JAX package's ``serving/export.py``).

The JAX package ships a ``jax.export`` of the jitted eval step; the port
ships a ``torch.export`` ``ExportedProgram`` of ``OcOccNetWithLoss.predict``.
The program pins the computation (shapes, dtypes, the layout of the
config) and runs without the model code: ``load_bundle`` imports nothing
from ``models/``, ``ops/`` or ``configs/``. The parameters stay an argument
of the program (``torch.func.functional_call`` over a state dict), so one
bundle serves any checkpoint of the same shapes. A bundle directory is

    bundle/
      eval_step.pt2   the ExportedProgram (torch.export.save)
      params.npz      flat {state-dict name: array} parameters
      meta.json       the config, the batch's shapes and the device

The program is exported for one device, the card unless the caller asks
for the CPU, and is served there: JAX's ``platforms=('tpu', 'cpu')``, one
artifact for several backends, has no counterpart.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable

import numpy as np
import torch

PROGRAM = "eval_step.pt2"


@dataclasses.dataclass
class ServingBundle:
    run: Callable          # (batch fields) -> predictions dict
    meta: dict


class _Predict(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model.predict(batch)


class _EvalStep(torch.nn.Module):
    """``(params, *fields) -> model.predict(TrackletBatch(*fields))`` with
    ``params`` (a state dict) swapped in for the model's parameters. The
    model is held outside the module tree, so the exported program owns no
    parameter; its buffers (constants of the config) are the program's
    constants."""

    def __init__(self, model, batch_type):
        super().__init__()
        object.__setattr__(self, "_predict", _Predict(model))
        self._batch_type = batch_type

    def forward(self, params: dict, *fields):
        return torch.func.functional_call(
            self._predict, {f"model.{k}": v for k, v in params.items()},
            (self._batch_type(*fields),))


def export_eval_step(cfg, params: dict, sample_batch, device="cuda"):
    """``(ExportedProgram, meta)`` of ``OcOccNetWithLoss(cfg).predict`` on
    batches shaped as ``sample_batch`` (a ``TrackletBatch``), on
    ``device`` (``cuda`` unless the caller asks for the CPU); ``params``
    (a state dict) only sets the parameters' shapes and dtypes."""
    from ..data.tracklet import TrackletBatch
    from ..models.ococcnet import OcOccNetWithLoss
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    model = OcOccNetWithLoss(cfg, dev).eval()
    plain = {k: v.to(dev) for k, v in params.items()}
    fields = tuple(x.to(dev) for x in sample_batch)
    with torch.no_grad():
        program = torch.export.export(_EvalStep(model, TrackletBatch),
                                      (plain, *fields), strict=False)
    meta = {
        "config": {k: v for k, v in dataclasses.asdict(cfg).items()
                   if isinstance(v, (int, float, str, bool, list, tuple,
                                     type(None)))},
        "batch_shapes": {f: list(getattr(sample_batch, f).shape)
                         for f in TrackletBatch._fields},
        "device": str(dev),
    }
    return program, meta


def save_bundle(out_dir: str, cfg, params: dict, sample_batch,
                device="cuda") -> str:
    """Export the eval step (``export_eval_step``) and write the bundle
    with ``params`` to ``out_dir``; returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    program, meta = export_eval_step(cfg, params, sample_batch, device)
    # the tracing inputs (the parameters among them) stay out of the file
    program.example_inputs = None
    torch.export.save(program, os.path.join(out_dir, PROGRAM))
    np.savez(os.path.join(out_dir, "params.npz"),
             **{k: v.detach().cpu().numpy() for k, v in params.items()})
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def load_bundle(bundle_dir: str, params: dict | None = None
                ) -> ServingBundle:
    """Load a bundle without the model code: the program and the
    parameters (``params``, a state dict of the same shapes, in place of
    the bundle's own), on the device it was exported for. ``run(batch)``
    takes a ``TrackletBatch`` or its fields in order."""
    with open(os.path.join(bundle_dir, "meta.json")) as f:
        meta = json.load(f)
    dev = torch.device(meta["device"])
    program = torch.export.load(os.path.join(bundle_dir, PROGRAM)).module()
    if params is None:
        npz = np.load(os.path.join(bundle_dir, "params.npz"))
        params = {k: torch.from_numpy(npz[k]) for k in npz.files}
    params = {k: v.to(dev) for k, v in params.items()}

    def run(batch):
        with torch.no_grad():
            return program(params, *(x.to(dev) for x in batch))

    return ServingBundle(run=run, meta=meta)
