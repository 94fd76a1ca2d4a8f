"""The port's data-parallel training on the CPU: two ``gloo`` ranks on
127.0.0.1 (``tests/torch_ddp_worker.py``, each process killed at 120 s)
against one process on the global batch, and against the JAX package's
``make_train_step`` on a 2-device CPU mesh.

The OcOccNet case's two halves hold different positive counts and train
with dropout on, so the ranks agree with the global batch only through the
global denominators (``parallel/multihost.py::global_sum`` in the losses)
and the dropout counter's rank offset (``models/layers.py::DropoutKeys``).
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.configs import ococcnet_config as jcfgm
from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_tpu.parallel import train as jtrain
from objectcentricocccompletion_tpu.training import optim as joptim
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.data import loader as tloader
from objectcentricocccompletion_torch.data.tracklet import TrackletBatch
from objectcentricocccompletion_torch.data.tracklet_dataset import (
    TrackletDataset)
from objectcentricocccompletion_torch.models.layers import (DropoutKeys,
                                                            dropout)
from objectcentricocccompletion_torch.parallel import train as ttrain
from objectcentricocccompletion_torch.tools import train as tcli
from objectcentricocccompletion_torch.training.trainer import train
from tests import torch_ddp_worker as worker
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_WAIT = 120.0
# one process against two ranks: float32 sums in another order (the
# ranks' halves, then the all-reduce)
PARAM_ATOL = 1e-6
GRAD_RTOL = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argvs, cwd=REPO):
    """Each argv in a process of its own session, with one torch thread;
    every one still running at ``RANK_WAIT`` s is killed, which fails the
    test with its output."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              start_new_session=True) for argv in argvs]
    deadline = time.monotonic() + RANK_WAIT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        outs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, (p.args, out[-3000:])
    return outs


def run_worker(cases, out, world=2):
    """``cases`` of ``tests/torch_ddp_worker.py`` in turn, in one launch of
    ``world`` ranks: ``{case: [rank 0's result, ...]}``."""
    port = free_port()
    run_ranks([[sys.executable, os.path.join(REPO, "tests",
                                             "torch_ddp_worker.py"),
                ",".join(cases), str(r), str(world), str(port), str(out)]
               for r in range(world)])
    # the files of this test's own workers (metrics hold numpy scalars)
    return {case: [torch.load(os.path.join(out, f"{case}.rank{r}.pt"),
                              weights_only=False) for r in range(world)]
            for case in cases}


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """The OcOccNet (dropout on and off) and SST cases on two gloo ranks,
    in one launch."""
    return run_worker(("ococc", "ococc_nodrop", "sst"),
                      tmp_path_factory.mktemp("ranks"))


def assert_like_one_process(ranks, ref):
    """Every rank's metrics, clipped gradients and parameters against the
    one-process step's; the ranks' parameters bit-equal."""
    for got in ranks:
        assert set(got["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-6,
                                                      abs=1e-7), k
        scale = max(float(g.abs().max()) for g in ref["grads"].values())
        for n, g in ref["grads"].items():
            err = float((got["grads"][n] - g).abs().max())
            assert err <= GRAD_RTOL * scale, (n, err)
        for n, p in ref["params"].items():
            err = float((got["params"][n] - p).abs().max())
            assert err <= PARAM_ATOL, (n, err)
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n


def test_two_ranks_equal_the_global_batch_with_dropout(rank_runs):
    # the ranks' masks differ, and together are the global batch's draw
    base = torch.tensor([5, 3])
    ones = torch.ones(4, 3, 8)
    whole = dropout(ones, 0.5, DropoutKeys(base))
    halves = [dropout(ones[:2], 0.5, DropoutKeys(base, rank=r))
              for r in (0, 1)]
    assert not torch.equal(halves[0], halves[1])
    assert torch.equal(torch.cat(halves), whole)
    cfg, batch = worker.ococc_case(dropout=True)
    assert cfg.fusion_dropout > 0 and cfg.attn_dropout > 0
    pos = (batch.gt_valid.float().sum((1,)))
    assert float(pos[:2].sum()) != float(pos[2:].sum())
    ranks = rank_runs["ococc"]
    assert_like_one_process(ranks, worker.ococc_step(cfg, batch))
    # make_train_multi_step: K steps over a [K, B] batch, the metrics
    # stacked [K], equal to K lone steps (the dropout counter follows them)
    two = TrackletBatch(*(torch.stack([x[:2], x[2:]]) for x in batch))
    runs = []
    for multi in (True, False):
        model, opt, schedule = ttrain.create_train_state(cfg, 10, "cpu")
        if multi:
            rows = ttrain.make_train_multi_step(model, opt, schedule)(3, two)
        else:
            step = ttrain.make_train_step(model, opt, schedule)
            rows = [step(3 + k, TrackletBatch(*(x[k] for x in two)))
                    for k in range(2)]
            rows = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        runs.append((rows, model.state_dict()))
    assert runs[0][0]["loss"].shape == (2,)
    for k, v in runs[1][0].items():
        assert torch.equal(runs[0][0][k], v), k
    for n, p in runs[1][1].items():
        assert torch.equal(runs[0][1][n], p), n


def _jax_step(cfg, batch, lr_steps=10):
    """The JAX ``make_train_step`` on a 2-device CPU mesh from the port's
    init (seed 0), and the JAX gradients of the same loss on that mesh."""
    jcfg = jcfgm.OcOccNetConfig(**dataclasses.asdict(cfg))
    model, _, _ = ttrain.create_train_state(cfg, lr_steps, "cpu", seed=0)
    params = convert.state_dict_to_flax(model.state_dict())
    tx, _ = joptim.make_optimizer(cfg.base_lr, lr_steps,
                                  weight_decay=cfg.weight_decay,
                                  grad_clip=cfg.grad_clip_norm,
                                  peak_ratio=cfg.lr_mult)
    mesh = jtrain.make_mesh(jax.devices()[:2])
    jmodel = jnet.OcOccNetWithLoss(jcfg)
    state = jax.device_put(jtrain.TrainState(
        jnp.zeros((), jnp.int32), params, jax.jit(tx.init)(params)),
        jtrain.replicated(mesh))
    jb = jtrain.shard_batch(jnet.TrackletBatch(*(x.numpy() for x in batch)),
                            mesh)

    def loss(p, b):
        return jmodel.apply({"params": p}, b, train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})[0]

    grads = jax.jit(jax.grad(loss))(state.params, jb)
    step = jtrain.make_train_step(jmodel, tx, mesh)
    new, aux = step(state, jb, jax.random.PRNGKey(0))
    return (convert.flax_to_state_dict(jax.device_get(new.params)),
            {k: float(v) for k, v in aux.items()},
            convert.flax_to_state_dict(jax.device_get(grads)))


def test_two_ranks_equal_the_jax_two_device_step(rank_runs):
    """Dropout off (the JAX masks come from flax's key stream): losses,
    metrics and ``grad_norm`` at 1e-4, every gradient at the 1e-4 bar of
    ``tests/test_grad_transplant_parity.py``, parameters within 2 lr of
    AdamW's first step (its sign may differ where a gradient is float
    noise around 0) plus rounding."""
    cfg, batch = worker.ococc_case(dropout=False)
    ranks = rank_runs["ococc_nodrop"]
    params, aux, grads = _jax_step(cfg, batch)
    got = ranks[0]
    assert set(got["metrics"]) == set(aux)
    for k, v in aux.items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-4, abs=1e-5), k
    norm = aux["grad_norm"]
    clip = min(1.0, cfg.grad_clip_norm / norm)
    scale = max(float(g.abs().max()) for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy() * clip,
                                   rtol=5e-3, atol=1e-4 * max(scale, 1.0),
                                   err_msg=n)
    lr = cfg.base_lr
    for n, p in params.items():
        assert float((got["params"][n] - p).abs().max()) <= 2 * lr + 1e-6, n


def test_sst_two_ranks_equal_the_global_batch(rank_runs):
    ranks = rank_runs["sst"]
    assert_like_one_process(ranks, worker.sst_step(worker.sst_case()))


def test_cli_two_processes_equal_one_at_twice_the_batch(tmp_path):
    """``tools/train.py ococcnet --tiny --device cpu --num-processes 2``
    against ``train`` in one process at twice the batch: rank 0's
    ``metrics.jsonl`` (the global batch's, rounded to 6 decimals as
    logged) and the final checkpoint."""
    paths = tloader.write_synthetic_dataset(str(tmp_path / "data"),
                                            num_tracklets=5, track_len=12,
                                            seed=2)
    flags = ["--proposals", paths["proposals_file"], "--gt-candidates",
             paths["gt_candidates_file"], "--poses", paths["pose_file"],
             "--occ-root", paths["occ_anno_root"]]
    work = tmp_path / "two"
    port = free_port()
    run_ranks([[sys.executable, "-m",
                "objectcentricocccompletion_torch.tools.train", "ococcnet",
                *flags, "--tiny", "--device", "cpu", "--total-steps", "2",
                "--log-interval", "1", "--work-dir", str(work),
                "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                "2", "--process-id", str(r)] for r in range(2)])
    cfg = tcli.ococc_train_config("ococcnet", tiny=True)
    ds = TrackletDataset(cfg=cfg, class_names=cfg.class_names, **paths)
    one = tmp_path / "one"
    train(dataclasses.replace(cfg, batch_size=2 * cfg.batch_size), ds,
          str(one), total_steps=2, log_interval=1, device="cpu")
    rows = [[json.loads(line) for line in open(d / "metrics.jsonl")]
            for d in (work, one)]
    assert [r["step"] for r in rows[0]] == [r["step"] for r in rows[1]] \
        == [1, 2]
    for got, ref in zip(*rows):
        for k, v in ref.items():
            if k not in ("time", "tracklets_per_sec"):
                assert got[k] == pytest.approx(v, abs=2e-6), k
    states = [torch.load(d / "ckpt" / "step_2.pt") for d in (work, one)]
    assert "optimizer" in states[0]
    for n, p in states[1]["model"].items():
        assert float((states[0]["model"][n] - p).abs().max()) \
            <= PARAM_ATOL, n
