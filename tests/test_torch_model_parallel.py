"""The port's model parallelism on the CPU: the layout rules against the
JAX package's, and two or four ``gloo`` ranks on 127.0.0.1
(``tests/torch_mp_worker.py``, each process killed at 120 s) against one
process on the global batch and against the JAX package's model-parallel
``make_train_step`` on a 2-device CPU mesh.

The rank cases run the packed tiny layout of the JAX package's
sequence-parallel test (32 blocks of 2 points, 16 per model rank) with
dropout on, so the ranks agree with one process only through the combined
segment tables, the gradients summed over the model group and each dropout
element's global counter.
"""
import dataclasses
import json
import os
import sys

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
from objectcentricocccompletion_torch.configs.ococcnet_config import (
    OcOccNetConfig, tiny_config)
from objectcentricocccompletion_torch.data import loader as tloader
from objectcentricocccompletion_torch.data.tracklet_dataset import (
    TrackletDataset)
from objectcentricocccompletion_torch.models.layers import (DropoutKeys,
                                                            dropout)
from objectcentricocccompletion_torch.models.ococcnet import (
    OcOccNet, OcOccNetWithLoss)
from objectcentricocccompletion_torch.parallel import multihost, sp
from objectcentricocccompletion_torch.parallel import train as ttrain
from objectcentricocccompletion_torch.tools import train as tcli
from objectcentricocccompletion_torch.training import surgery
from objectcentricocccompletion_torch.training.trainer import (
    CheckpointManager, train)
from tests import torch_mp_worker as worker
from tests.test_torch_ddp import (PARAM_ATOL, REPO, assert_like_one_process,
                                  free_port, run_ranks)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

# the 24 kernels the JAX rule shards at full width (min_dim 1024)
FULL_WIDTH_TP = {"net/" + n for n in (
    {f"{m}/Dense_{i}" for m in ("conv_fused", "conv_latent")
     for i in range(3)}
    | {"occ_decoder/mlp/Dense_0", "occ_decoder/mlp/Dense_1",
       "roi_pos_enc/Dense_2"}
    | {f"temporal/layer_{n}/self_attn/{p}" for n in range(3)
       for p in ("q", "k", "v", "out")}
    | {f"temporal/layer_{n}/linear2" for n in range(3)})}


def _flax_dims(model, plan):
    """The port's ``{name: torch dim}`` as ``{flax path: flax dim}``."""
    out = {}
    for name, p in model.named_parameters():
        path, perm, _ = convert.flax_leaf(name, tuple(p.shape))
        d = plan[name]
        out["/".join(path)] = None if d is None else perm.index(d)
    return out


def _jax_dims(shardings):
    """The JAX layout's ``{flax path: sharded dim or None}``."""
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    out = {}
    for path, sh in flat:
        spec = tuple(sh.spec)
        dims = [i for i, a in enumerate(spec) if a is not None]
        out["/".join(k.key for k in path)] = dims[0] if dims else None
    return out


def test_layout_rules_mesh_and_sliced_dropout():
    """TP and FSDP pick the JAX package's leaves and dims (through the
    converter's name map) on ``tiny_config()`` on a 4 x 2 mesh, and TP the
    24 kernels at full width; ``make_multihost_mesh`` refuses what JAX
    asserts; a sliced dropout site draws the slice of one process's
    mask."""
    model = OcOccNetWithLoss(tiny_config(), "cpu",
                             torch.Generator().manual_seed(0))
    params = convert.state_dict_to_flax(model.state_dict())
    mesh = jtrain.make_mesh_2d(4, 2, jax.devices()[:8])
    sizes = {"data": 4, "model": 2}
    for port, ref in ((ttrain.param_shardings(model, sizes, min_dim=32),
                       jtrain.param_shardings(params, mesh, min_dim=32)),
                      (ttrain.param_shardings_fsdp(model, sizes,
                                                   min_size=256),
                       jtrain.param_shardings_fsdp(params, mesh,
                                                   min_size=256))):
        got, want = _flax_dims(model, port), _jax_dims(ref)
        assert got == want
        assert 10 < sum(d is not None for d in got.values()) < len(got)

    with torch.device("meta"):
        full = torch.nn.Module()
        full.net = OcOccNet(OcOccNetConfig())
    plan = ttrain.param_shardings(full, {"data": 1, "model": 2})
    tp = {n for n, d in _flax_dims(full, plan).items() if d is not None}
    assert {n.rsplit("/", 1)[0] for n in tp} == FULL_WIDTH_TP
    assert all(n.endswith("/kernel") for n in tp)
    named = dict(full.named_parameters())
    assert sum(named[n].numel() for n, d in plan.items() if d is not None) \
        == 60_293_120
    assert sum(p.numel() for p in named.values()) == 66_553_173
    fsdp = ttrain.param_shardings_fsdp(full, {"data": 2})
    assert sum(named[n].numel() for n, d in fsdp.items()
               if d is not None) == 66_191_360

    for bad in (dict(model_axis_size=3, world=4),
                dict(model_axis_size=4, world=8, per_host=2),
                dict(model_axis_size=2, world=1)):
        with pytest.raises(ValueError, match="--tp"):
            multihost.make_multihost_mesh(**bad)
    assert multihost.make_multihost_mesh(1, world=1) is None

    base = torch.tensor([7, 2])
    for shape, dim in (((4, 8, 6), 1), ((4, 3, 8, 5), 2)):
        whole = dropout(torch.ones(shape), 0.5, DropoutKeys(base))
        for r in (0, 1):                      # data rank of 2
            for off in (0, 4):                # model slice of 2
                local = list(shape)
                local[0], local[dim] = 2, 4
                with sp.region(dim, off, shape[dim]):
                    got = dropout(torch.ones(local), 0.5,
                                  DropoutKeys(base, rank=r))
                want = whole[2 * r:2 * r + 2].narrow(dim, off, 4)
                assert torch.equal(got, want), (shape, r, off)


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """Both cases of ``tests/torch_mp_worker.py`` on two gloo ranks, in
    one launch: ``{case: [rank 0's, rank 1's]}``."""
    out = tmp_path_factory.mktemp("ranks")
    port = free_port()
    run_ranks([[sys.executable, os.path.join(REPO, "tests",
                                             "torch_mp_worker.py"), str(r),
                "2", str(port), str(out)] for r in range(2)])
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return {case: [r[case] for r in ranks] for case in worker.CASES}


@pytest.fixture(scope="module")
def one_process():
    """The packed case with dropout in one process on the global batch
    (one run, shared by the rank tests)."""
    return worker.mp_step(*worker.packed_case(dropout=True))


@pytest.fixture(scope="module")
def jax_ref():
    """The packed case without dropout on the JAX side, from the port's
    init (seed 0): its config, batch, params, AdamW, model and the
    gradients of its loss (one jit, shared by the rank tests)."""
    cfg, batch = worker.packed_case(dropout=False)
    jcfg = jcfgm.OcOccNetConfig(**dataclasses.asdict(cfg))
    model, _, _ = ttrain.create_train_state(cfg, 10, "cpu", seed=0)
    params = convert.state_dict_to_flax(model.state_dict())
    tx, _ = joptim.make_optimizer(cfg.base_lr, 10,
                                  weight_decay=cfg.weight_decay,
                                  grad_clip=cfg.grad_clip_norm,
                                  peak_ratio=cfg.lr_mult)
    jmodel = jnet.OcOccNetWithLoss(jcfg)
    jb = jnet.TrackletBatch(*(x.numpy() for x in batch))

    def loss(p, b):
        return jmodel.apply({"params": p}, b, train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})[0]

    grads = jax.jit(jax.grad(loss))(params, jb)
    return cfg, jb, params, tx, jmodel, convert.flax_to_state_dict(
        jax.device_get(grads))


def _jax_step(ref, mesh, **kw):
    """The JAX ``make_train_step`` with ``kw``'s model-parallel layout on
    ``mesh`` from ``jax_ref``'s state: the parameters after it, the
    metrics, and ``jax_ref``'s gradients."""
    cfg, jb, params, tx, jmodel, grads = ref
    state = jtrain.TrainState(jnp.zeros((), jnp.int32), params,
                              jax.jit(tx.init)(params))
    state = jax.device_put(state, jtrain._state_shardings(
        state, mesh, kw.get("tp_min_dim", 1024), kw.get("fsdp", False),
        kw.get("fsdp_min_size", 1 << 15)))
    step = jtrain.make_train_step(jmodel, tx, mesh, state=state, **kw)
    new, aux = step(state, jtrain.shard_batch(jb, mesh),
                    jax.random.PRNGKey(0))
    return (convert.flax_to_state_dict(jax.device_get(new.params)),
            {k: float(v) for k, v in aux.items()}, grads)


def assert_whole_checkpoint(ranks):
    """``Layout.full_state`` on every rank: the whole parameters and
    moments, as one process's checkpoint holds them; restored and laid out
    again, they give each rank its own shards back."""
    for r in ranks:
        assert r["resumed_shards_equal"]
        ck = r["checkpoint"]
        assert set(ck["params"]) == set(r["params"])
        for n, p in r["params"].items():
            assert torch.equal(ck["params"][n], p), n
        assert ck["moments"] == {n: tuple(p.shape)
                                 for n, p in r["params"].items()}


def assert_like_jax(cfg, got, jax_run):
    """``test_torch_ddp.py::test_two_ranks_equal_the_jax_two_device_step``'s
    bars: metrics at 1e-4, gradients at 5e-3 relative and 1e-4 of the
    largest, parameters within 2 lr."""
    params, aux, grads = jax_run
    assert set(got["metrics"]) == set(aux)
    for k, v in aux.items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-4, abs=1e-5), k
    clip = min(1.0, cfg.grad_clip_norm / aux["grad_norm"])
    scale = max(float(g.abs().max()) for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy() * clip,
                                   rtol=5e-3, atol=1e-4 * max(scale, 1.0),
                                   err_msg=n)
    for n, p in params.items():
        assert float((got["params"][n] - p).abs().max()) <= \
            2 * cfg.base_lr + 1e-6, n


def test_tp_sp_ranks_equal_one_process_and_the_jax_step(rank_runs, jax_ref,
                                                         one_process):
    """Mesh (1, 2), ``tp_min_dim=32``, sequence parallelism on the packed
    layout: both ranks equal one process on the batch (dropout on), and
    the JAX step on a 1 x 2 mesh with the same options (dropout off)."""
    ranks = rank_runs["tp_sp"]
    assert ranks[0][True]["dims"] and all(
        d == 0 for d in ranks[0][True]["dims"].values())
    # the SP setting lives only while a step runs
    assert not any(r[d]["sp_after_step"] for r in ranks for d in r)
    assert_whole_checkpoint([r[True] for r in ranks])
    assert_like_one_process([r[True] for r in ranks], one_process)
    assert_like_jax(jax_ref[0], ranks[0][False], _jax_step(
        jax_ref, jtrain.make_mesh_2d(1, 2, jax.devices()[:2]),
        tp_min_dim=32, sequence_parallel=True))


def test_fsdp_ranks_equal_one_process_and_the_jax_step(rank_runs, jax_ref,
                                                       one_process):
    """Mesh (2, 1), ``fsdp_min_size=256``: each rank's parameter and moment
    shards have the rule's shapes; both ranks equal one process on the
    global batch (dropout on), and the JAX FSDP step on 2 devices (dropout
    off)."""
    ranks = rank_runs["fsdp"]
    cfg, _ = worker.packed_case(dropout=True)
    model = OcOccNetWithLoss(cfg, "cpu")
    rule = ttrain.param_shardings_fsdp(model, {"data": 2}, min_size=256)
    for res in ranks:
        got = res[True]
        assert got["dims"] == {n: d for n, d in rule.items()
                               if d is not None}
        for n, p in model.named_parameters():
            shape = list(p.shape)
            if rule[n] is not None:
                shape[rule[n]] //= 2
            assert got["shards"][n] == tuple(shape) == got["moments"][n], n
    assert_whole_checkpoint([r[True] for r in ranks])
    assert_like_one_process([r[True] for r in ranks], one_process)
    assert_like_jax(jax_ref[0], ranks[0][False], _jax_step(
        jax_ref, jtrain.make_mesh(jax.devices()[:2]), fsdp=True,
        fsdp_min_size=256))


def test_cli_four_processes_equal_one_at_twice_the_batch(tmp_path):
    """``tools/train.py ococcnet --tiny --device cpu --tp 2 --fsdp
    --sequence-parallel`` in four processes (mesh (2, 2)) against ``train``
    in one process at twice the batch: ``metrics.jsonl`` and the final
    checkpoint, which restores in one process under the same name."""
    paths = tloader.write_synthetic_dataset(str(tmp_path / "data"),
                                            num_tracklets=5, track_len=12,
                                            seed=2)
    flags = ["--proposals", paths["proposals_file"], "--gt-candidates",
             paths["gt_candidates_file"], "--poses", paths["pose_file"],
             "--occ-root", paths["occ_anno_root"]]
    work = tmp_path / "four"
    port = free_port()
    run_ranks([[sys.executable, "-m",
                "objectcentricocccompletion_torch.tools.train", "ococcnet",
                *flags, "--tiny", "--device", "cpu", "--total-steps", "2",
                "--log-interval", "1", "--work-dir", str(work),
                "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                "4", "--process-id", str(r), "--tp", "2", "--fsdp",
                "--sequence-parallel"] for r in range(4)])
    cfg = tcli.ococc_train_config("ococcnet", tiny=True)
    ds = TrackletDataset(cfg=cfg, **paths)
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
    for n, p in states[1]["model"].items():
        assert states[0]["model"][n].shape == p.shape
        assert float((states[0]["model"][n] - p).abs().max()) \
            <= PARAM_ATOL, n
    model, optimizer, _ = ttrain.create_train_state(cfg, 2, "cpu")
    assert CheckpointManager(str(work / "ckpt")).restore(model,
                                                         optimizer) == 2
    assert all(st["exp_avg"].shape == p.shape
               for p, st in optimizer.state.items())
    assert len(optimizer.state) == len(list(model.parameters()))
    assert surgery.tree_hash(model.state_dict()) == \
        surgery.tree_hash(states[0]["model"])
