"""OcOccNet's ``remat_sir`` and the tracklet loader's worker processes in
the port, held against the JAX package on the CPU.

``remat_sir`` recomputes the SIR encoders in the backward
(``torch.utils.checkpoint``) on the dense layout: its gradients equal those
without it (within 1e-6; recomputation is exact with no dropout in SIR) and
JAX's ``nn.remat`` gradients (within 1e-4); the packed layout ignores it,
as JAX's does. ``PrefetchLoader`` batches equal the JAX package's
``TrackletDataset.build_sample`` on the (index, seed) schedule drawn here
from the seeded ``RandomState``; no JAX worker is spawned, and every wait
on a worker is bounded.

A file of at most four tests (pytest-xdist's ``--dist loadfile`` hands out
the files with the most tests first)."""
import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.data import tracklet_dataset as jtd
from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.data import loader as tloader
from objectcentricocccompletion_torch.data import tracklet_dataset as ttd
from objectcentricocccompletion_torch.tools import train as tcli
from tests.test_torch_ococc_train import CONFIGS, FP32_TOL, _compare_losses
from tests.test_torch_ococcnet import (_batch, _jbatch, _params,
                                       _port_model, _torch_config)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

GRAD_TOL = 1e-4
SAME_TOL = 1e-6
WAIT = 120.0            # seconds for any one batch of the worker pool
DATA = dict(num_tracklets=5, track_len=12, seed=2)


def _grads(model, b):
    total, losses = model(b)
    total.backward()
    return losses, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_gradients_equal_plain_and_jax_remat():
    """Dense layout: the port's gradients with ``remat_sir`` equal its
    gradients without it and JAX's under ``nn.remat``."""
    cfg = dataclasses.replace(CONFIGS["dense"], remat_sir=True)
    params = _params("ococc")
    b = _batch(cfg)
    jmodel = jnet.OcOccNetWithLoss(cfg)
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, x: jmodel.apply({"params": p}, x, train=True),
        has_aux=True))(params, _jbatch(b))
    remat = _port_model(cfg, params).train()
    plain = _port_model(CONFIGS["dense"], params).train()
    got, grads = _grads(remat, b)
    _, plain_grads = _grads(plain, b)
    _compare_losses(got, ref, FP32_TOL)
    ref_grads = convert.flax_to_state_dict(jax.device_get(ref_grads))
    assert set(ref_grads) == set(grads) == set(plain_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), plain_grads[k].numpy(),
                                   atol=SAME_TOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(g.numpy(), ref_grads[k].numpy(),
                                   atol=GRAD_TOL, rtol=0, err_msg=k)
    # the encoders ran under checkpoint: the backward recomputed them
    seen = []
    hook = remat.net.roi_encoder.register_forward_pre_hook(
        lambda *a: seen.append(1))
    try:
        _grads(remat, b)
    finally:
        hook.remove()
    assert len(seen) == 2            # the forward and the recomputation


def test_packed_layout_ignores_remat_as_jax_does():
    """Packed layout with ``remat_sir``: the losses equal JAX's for the same
    config, and the gradients equal those without the option exactly."""
    cfg = dataclasses.replace(CONFIGS["packed"], remat_sir=True)
    params = _params("ococc")
    b = _batch(cfg)
    jmodel = jnet.OcOccNetWithLoss(cfg)
    _, ref = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                               train=True))(params, _jbatch(b))
    got, grads = _grads(_port_model(cfg, params).train(), b)
    _compare_losses(got, jax.device_get(ref), FP32_TOL)
    _, plain = _grads(_port_model(CONFIGS["packed"], params).train(), b)
    assert all(torch.equal(g, plain[k]) for k, g in grads.items())


def test_prefetch_loader_batches_equal_the_jax_schedule(tmp_path):
    """Three batches of 2 from ``PrefetchLoader(workers=2)`` equal the JAX
    package's samples built on the schedule: the epoch permutation of
    ``RandomState(seed)``, then one ``randint(0, 2**31 - 1)`` per sample,
    each sample built from ``RandomState`` of its seed. Workers that end
    fail the loader within its poll instead of hanging it, and ``close``
    returns within its bound."""
    paths = tloader.write_synthetic_dataset(str(tmp_path), **DATA)
    cfg = CONFIGS["dense"]
    jds = jtd.TrackletDataset(cfg=cfg, **paths)
    rng, order, tasks = np.random.RandomState(4), [], []
    for _ in range(3 * 2):
        if not order:
            order = list(rng.permutation(len(jds)))
        tasks.append((order.pop(), int(rng.randint(0, 2 ** 31 - 1))))
    loader = tloader.PrefetchLoader(
        ttd.TrackletDataset(cfg=_torch_config(cfg), **paths), 2, seed=4,
        workers=2, prefetch=2, timeout=WAIT)
    try:
        batches = [next(loader) for _ in range(3)]
        for proc, _, _ in loader._workers:
            proc.kill()
        with pytest.raises(RuntimeError, match="ended"):
            for _ in range(4):       # at most the 2 prefetched batches come
                next(loader)
    finally:
        t0 = time.monotonic()
        loader.close()
        assert time.monotonic() - t0 < 2 * loader.CLOSE_WAIT
    for i, batch in enumerate(batches):
        ref = [jds.build_sample(idx, np.random.RandomState(seed))
               for idx, seed in tasks[2 * i:2 * i + 2]]
        for name, got in zip(batch._fields, batch):
            np.testing.assert_array_equal(
                got.numpy(), np.stack([r[name] for r in ref]),
                err_msg=f"batch {i} {name}")


def test_cli_with_loader_workers(tmp_path):
    """``tools/train.py ococcnet --loader-workers 2`` for 2 steps on the
    CPU: logged and checkpointed; its weights equal those of the same run
    with 1 worker (the batches do not depend on the count)."""
    paths = tloader.write_synthetic_dataset(str(tmp_path / "data"), **DATA)
    flags = ["--proposals", paths["proposals_file"], "--gt-candidates",
             paths["gt_candidates_file"], "--poses", paths["pose_file"],
             "--occ-root", paths["occ_anno_root"], "--tiny", "--device",
             "cpu", "--total-steps", "2", "--log-interval", "1"]
    trained = []
    for workers in (2, 1):
        work = str(tmp_path / f"w{workers}")
        assert tcli.main(["ococcnet", *flags, "--work-dir", work,
                          "--loader-workers", str(workers)]) == 2
        rows = [json.loads(line)
                for line in open(os.path.join(work, "metrics.jsonl"))]
        assert [r["step"] for r in rows] == [1, 2]
        assert all(np.isfinite(r["loss"]) for r in rows)
        trained.append(torch.load(os.path.join(work, "ckpt", "step_2.pt"),
                                  weights_only=True)["model"])
    assert all(torch.equal(v, trained[1][k]) for k, v in trained[0].items())
