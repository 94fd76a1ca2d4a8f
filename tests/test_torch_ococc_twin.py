"""The port's tracklet data and OcOccNet training loop held against the JAX
package on the CPU: ``write_synthetic_dataset`` writes the same files,
``TrackletDataset.build_sample`` gives the same arrays and ``TrainLoader``
the same batches; a twin run of the tiny model (one converted init, the
same batches, the JAX ``make_train_step`` against the port's) tracks the
JAX losses. Then the port's CLI trains, logs, checkpoints and resumes on
the CPU, refuses what is not ported, and the CUDA entry points raise
without a card."""
import dataclasses
import json
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.configs import ococcnet_config as jcfgm
from objectcentricocccompletion_tpu.data import loader as jloader
from objectcentricocccompletion_tpu.data import tracklet_dataset as jtd
from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_tpu.parallel import train as jtrain
from objectcentricocccompletion_tpu.training import optim as joptim
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.configs import ococcnet_config as tcfgm
from objectcentricocccompletion_torch.data import loader as tloader
from objectcentricocccompletion_torch.data.synthetic import synthetic_batch
from objectcentricocccompletion_torch.data import tracklet_dataset as ttd
from objectcentricocccompletion_torch.parallel import train as ttrain
from objectcentricocccompletion_torch.tools import benchmark as bench
from objectcentricocccompletion_torch.tools import train as tcli
from tests.test_torch_ococcnet import _params, _torch_config

TINY = dataclasses.replace(
    jcfgm.tiny_config(), occ_dropout=0.0, attn_dropout=0.0, cls_dropout=0.0,
    reg_dropout=0.0, latent_dropout=0.0, fusion_dropout=0.0)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401
DATA = dict(num_tracklets=5, track_len=12, seed=2)
TWIN_STEPS = 5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tracklets"))
    return tloader.write_synthetic_dataset(root, **DATA), root


def _datasets(paths, cfg=TINY):
    return (ttd.TrackletDataset(cfg=_torch_config(cfg), **paths),
            jtd.TrackletDataset(cfg=cfg, **paths))


def test_synthetic_dataset_and_samples_equal_the_jax_package(data,
                                                             tmp_path):
    paths, root = data
    jpaths = jloader.write_synthetic_dataset(str(tmp_path), **DATA)
    for key in ("proposals_file", "gt_candidates_file", "pose_file"):
        with open(paths[key], "rb") as a, open(jpaths[key], "rb") as b:
            assert pickle.dumps(pickle.load(a)) == \
                pickle.dumps(pickle.load(b)), key
    for sub, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pkl"):
                continue
            rel = os.path.relpath(os.path.join(sub, f), root)
            got = np.load(os.path.join(root, rel), allow_pickle=True)
            ref = np.load(os.path.join(tmp_path, rel), allow_pickle=True)
            if rel.endswith(".npz"):
                got, ref = got["occ"], ref["occ"]
            else:
                got, ref = np.concatenate(list(got)), np.concatenate(list(ref))
            np.testing.assert_array_equal(got, ref, err_msg=rel)
    tds, jds = _datasets(paths)
    assert len(tds) == len(jds) == DATA["num_tracklets"]
    # training samples: candidate selection, regularisation, the box noise
    # and the augmentations draw from the RandomState
    for i in range(len(tds)):
        a = tds.build_sample(i, np.random.RandomState(i))
        b = jds.build_sample(i, np.random.RandomState(i))
        assert set(a) == set(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["points_mask"].any() and a["gt_valid"].any()


def test_loader_batches_equal_the_jax_package(data):
    paths, _ = data
    tds, jds = _datasets(paths)
    tl = tloader.make_loader(tds, 2, seed=3)
    jl = jloader.make_loader(jds, 2, seed=3)
    for _ in range(4):     # across an epoch boundary (5 tracklets)
        a, b = next(tl), next(jl)
        assert a._fields == b._fields
        for name, x, y in zip(a._fields, a, b):
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), name)
    prefetched = tloader.ThreadPrefetcher(tloader.make_loader(tds, 2,
                                                              seed=3))
    try:
        first = next(prefetched)
    finally:
        prefetched.close()
    assert not prefetched._thread.is_alive()
    for x, y in zip(first, next(tloader.make_loader(tds, 2, seed=3))):
        assert torch.equal(x, y)


def _loader_batches(data):
    """The port's and the JAX package's loader batches, in pairs."""
    tds, jds = _datasets(data[0])
    return zip(tloader.make_loader(tds, 2, seed=1),
               jloader.make_loader(jds, 2, seed=1))


def _twin(batches, steps, base_lr):
    """``steps`` steps at ``base_lr`` (the peak 100x that), dropout 0, from
    one converted init on the same batches (port, JAX pairs): the JAX step
    on a one-device CPU mesh against the port's. Returns both runs'
    losses, each parameter's final max abs difference and the schedule."""
    cfg = dataclasses.replace(TINY, base_lr=base_lr)
    params = _params("ococc")
    tx, _ = joptim.make_optimizer(cfg.base_lr, steps,
                                  weight_decay=cfg.weight_decay,
                                  grad_clip=cfg.grad_clip_norm,
                                  peak_ratio=cfg.lr_mult)
    mesh = jtrain.make_mesh(jax.devices()[:1])
    # the state placed as the step returns it (replicated on the mesh), so
    # that the step compiles once
    state = jax.device_put(jtrain.TrainState(
        jnp.zeros((), jnp.int32), params, jax.jit(tx.init)(params)),
        jtrain.replicated(mesh))
    jstep = jtrain.make_train_step(jnet.OcOccNetWithLoss(cfg), tx, mesh)
    tmodel, opt, schedule = ttrain.create_train_state(
        _torch_config(cfg), steps, "cpu")
    tmodel.load_state_dict(convert.flax_to_state_dict(params))
    tstep = ttrain.make_train_step(tmodel, opt, schedule)
    jls, tls = [], []
    for step, (tb, jb) in zip(range(steps), batches):
        state, aux = jstep(state, jb, jax.random.PRNGKey(step))
        got = tstep(step, tb)
        assert set(got) == set(aux)
        for k, v in got.items():
            assert np.isfinite(float(v)), k
        jls.append(float(aux["loss"]))
        tls.append(float(got["loss"]))
    final = convert.flax_to_state_dict(jax.device_get(state.params))
    diffs = {n: float((p.detach() - final[n]).abs().max())
             for n, p in tmodel.named_parameters()}
    return np.asarray(jls), np.asarray(tls), diffs, schedule


def test_twin_training(data):
    """Five steps of the loaders' batches of two tracklets at base_lr 1e-4
    (peak 1e-2 after the first step), so that the weights move within
    them."""
    jls, tls, diffs, schedule = _twin(_loader_batches(data), TWIN_STEPS,
                                      1e-4)
    rel = np.abs(tls - jls) / np.abs(jls)
    print(f"twin losses jax {jls} port {tls} max rel dev {rel.max():.2e}")
    assert abs(jls[-1] - jls[0]) > 0.05 * jls[0]     # the weights moved
    # the repository's twin-training bar: 6e-3
    assert rel.max() <= 6e-3, rel
    key_bias = {n for n in diffs if n.endswith(".k.bias")}
    worst = max(v for n, v in diffs.items() if n not in key_bias)
    print(f"twin final params max abs diff {worst:.2e}")
    # a hundredth of one step at the peak rate (1e-2): atol 1e-4
    assert worst <= 1e-4, diffs
    # the softmax is invariant to the key bias: its exact gradient is 0,
    # and Adam turns the float32 noise there into steps of up to lr in
    # either direction, so the two runs may part by twice the sum of lr
    lr_sum = sum(schedule(s) for s in range(TWIN_STEPS))
    assert all(diffs[n] <= 2 * lr_sum for n in key_bias)


@pytest.mark.slow
def test_twin_training_300_steps():
    """The repository's 300-step twin (``tests/test_twin_training.py``,
    whose run set the 6e-3 bar) in its design: a fresh batch every step
    (here ``synthetic_batch`` with the step's seed, the tiny config's 2
    tracklets) and its recipe, base_lr 1e-6, peak 1e-4, 10% ramp. On the
    5 loader tracklets instead, 300 steps are 120 epochs: the box
    residuals settle near 0, where the L1 loss has a kink, and a residual
    crossing 0 changes a gradient by a step (JAX's own gradient at the
    port's parameters, 1.5e-4 away, differs from it at its own by 7% in
    norm at step 164); there the losses part by up to 1.2e-2."""
    def fresh():
        for step in range(300):
            b = synthetic_batch(_torch_config(TINY), seed=1000 + step)
            yield b, jnet.TrackletBatch(*(x.numpy() for x in b))

    jls, tls, _, _ = _twin(fresh(), 300, TINY.base_lr)
    rel = np.abs(tls - jls) / np.abs(jls)
    print(f"300-step twin max rel dev {rel.max():.2e} at step "
          f"{int(rel.argmax())}; loss {jls[0]:.4f} -> {jls[-1]:.4f}")
    assert jls[-20:].mean() < 0.9 * jls[:5].mean()    # it trains
    assert rel.max() <= 6e-3, rel


def _cli_argv(paths, work, *extra):
    return ["ococcnet", "--proposals", paths["proposals_file"],
            "--gt-candidates", paths["gt_candidates_file"], "--poses",
            paths["pose_file"], "--occ-root", paths["occ_anno_root"],
            "--tiny", "--device", "cpu", "--work-dir", work,
            "--log-interval", "1", *extra]


def test_cli_trains_logs_checkpoints_and_resumes(data, tmp_path):
    paths, _ = data
    work = str(tmp_path / "run")
    seen = []

    def run(steps):
        return tcli.main(_cli_argv(paths, work, "--total-steps", str(steps)),
                         hooks=[lambda s, m: seen.append(s)])

    assert run(2) == 2 and seen == [1, 2]
    assert os.listdir(os.path.join(work, "ckpt")) == ["step_2.pt"]
    # resume from step 2 to 3: one step runs
    assert run(3) == 3 and seen == [1, 2, 3]
    rows = [json.loads(line)
            for line in open(os.path.join(work, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for r in rows:
        for k in ("loss", "loss_rcnn_cls", "loss_rcnn_bbox", "loss_rcnn_occ",
                  "grad_norm", "lr", "tracklets_per_sec", "cls_acc"):
            assert np.isfinite(r[k]), k
    # the lr logged is the step's (rounded to 6 decimals, as the logger
    # rounds): the tiny config's schedule of 3 steps
    sched = joptim.cyclic_cosine_schedule(jcfgm.tiny_config().base_lr, 3)
    assert rows[-1]["lr"] == round(float(sched(2)), 6) > 0
    ckpt = torch.load(os.path.join(work, "ckpt", "step_3.pt"),
                      weights_only=True)
    assert ckpt["step"] == 3 and "optimizer" in ckpt


@pytest.mark.parametrize("model,extra,kw", [
    ("ctrl", [], {}),
    ("ococcnet", ["--fixed-ae"], {"fixed_ae": True}),
    ("ococcnet", ["--dtype", "bfloat16"], {"dtype": "bfloat16"})])
def test_cli_variants_train(data, tmp_path, model, extra, kw):
    """CTRL (the vehicle variant, box losses only), the frozen auto-encoder
    and bf16 compute: a step each with finite losses; the weights move,
    and under --fixed-ae the auto-encoder's do not."""
    paths, _ = data
    work = str(tmp_path / "run")
    argv = [model] + _cli_argv(paths, work, "--total-steps", "1",
                               *extra)[1:]
    logs = []
    assert tcli.main(argv, hooks=[lambda s, m: logs.append(m)]) == 1
    assert all(np.isfinite(float(v)) for v in logs[0].values())
    assert ("loss_rcnn_corner" in logs[0]) == (model == "ctrl")
    cfg = tcli.ococc_train_config(model, tiny=True, **kw)
    assert (cfg.variant == "ctrl") == (model == "ctrl")
    trained = torch.load(os.path.join(work, "ckpt", "step_1.pt"),
                         weights_only=True)["model"]
    init = ttrain.create_train_state(cfg, 1, "cpu", seed=0)[0].state_dict()
    moved = {n for n, p in init.items() if not torch.equal(p, trained[n])}
    ae = {n for n in init if ".ae_encoder." in n}
    if cfg.fixed_ae:
        assert ae and not moved & ae and moved == set(init) - ae
    else:
        assert moved == set(init)


@pytest.mark.parametrize("extra", [["--tp", "2"], ["--fsdp"],
                                   ["--sequence-parallel"],
                                   ["--loader-workers", "2"],
                                   ["--coordinator", "localhost:1234"],
                                   ["--num-processes", "2"]])
def test_cli_refuses_what_is_not_ported(data, tmp_path, extra):
    paths, _ = data
    with pytest.raises(NotImplementedError, match=re.escape(extra[0])):
        tcli.main(_cli_argv(paths, str(tmp_path), *extra))


def test_benchmark_train_function_on_cpu():
    cfg = tcfgm.tiny_config()
    res = bench.bench_ococcnet_train(steps=1, dtype="float32",
                                     layout="packed", device="cpu", batch=2,
                                     cfg=dataclasses.replace(
                                         cfg, packed_point_budget=128,
                                         packed_quantum=16), warmup=1)
    assert res["mode"] == "train" and res["batch"] == 2
    assert res["fps"] == pytest.approx(2e3 / res["step_ms"])
    assert res["peak_memory_gib"] is None and res["point_slots"] == 256
    assert np.isfinite(res["metrics"]["loss"])
    assert res["metrics"]["grad_norm"] > 0


def test_cuda_entry_points_raise_without_a_card(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    paths, _ = data
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.create_train_state(tcfgm.tiny_config(), 10)
    argv = [a for a in _cli_argv(paths, str(tmp_path)) if a not in
            ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.bench_ococcnet_train(steps=1, cfg=tcfgm.tiny_config())
