"""CenterPoint training and evaluation in the port against the JAX package
on the CPU: a twin run of ``tiny_centerpoint_config()`` (one converted
init, the same batches of the same synthetic frames, the JAX
``make_detector_train_step`` against the port's) tracks the JAX losses to
the repository's twin bar (6e-3 relative); then ``tools/train.py centerpoint --tiny --device cpu`` trains
and checkpoints, and ``tools/test.py centerpoint`` evaluates that
checkpoint with the KITTI and the Waymo metrics.

A file of at most four tests (pytest-xdist's ``--dist loadfile``; see
``test_torch_centerpoint.py``)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.data import frame_dataset as jfd
from objectcentricocccompletion_tpu.models import centerpoint as jcp
from objectcentricocccompletion_tpu.parallel.train import make_mesh, replicated
from objectcentricocccompletion_tpu.training import detector_trainer as jdt
from objectcentricocccompletion_tpu.training.optim import (
    make_optimizer as jax_make_optimizer)
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.data import frame_dataset as tfd
from objectcentricocccompletion_torch.tools import test as tcli
from objectcentricocccompletion_torch.tools import train as ttrain
from objectcentricocccompletion_torch.training import detector_trainer as tdt
from objectcentricocccompletion_torch.training.optim import make_optimizer
from tests.test_torch_centerpoint import (TINY, param_tree, random_params,
                                          torch_model)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TWIN_STEPS = 5
# frames inside the tiny config's +-6.4 m range
FRAMES = dict(num_frames=3, num_points=3000, num_boxes=6, xy_range=5.5)
CLI_STEPS = 3


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cp_frames"))
    return tfd.write_synthetic_frames(root, seed=5, **FRAMES), root


def test_twin_training(frames):
    """Five steps of one frame each at base_lr 1e-4 (peak 1e-2 after the
    first step), from one converted init on the same batches."""
    info, root = frames
    kw = dict(max_points=TINY.max_points, max_gt=8)
    jloader = jdt.FrameLoader(jfd.FrameDataset(info, root, **kw), 1, seed=1)
    tloader = tdt.FrameLoader(tfd.FrameDataset(info, root, **kw), 1, seed=1)

    model = jcp.DynamicCenterPoint(TINY)
    first = next(jloader)
    params = random_params(param_tree(), 3)
    tx, _ = jax_make_optimizer(1e-4, TWIN_STEPS)
    mesh = make_mesh(jax.devices()[:1])
    state = jax.device_put(jdt.DetectorState(
        jnp.zeros((), jnp.int32), params, jax.jit(tx.init)(params)),
        replicated(mesh))
    jstep = jdt.make_detector_train_step(model, tx, mesh)

    tmodel = torch_model(params).train()
    opt, schedule = make_optimizer(tmodel.named_parameters(), 1e-4,
                                   TWIN_STEPS)
    tstep = tdt.make_detector_train_step(tmodel, opt, schedule)

    jl, tl = [], []
    for step in range(TWIN_STEPS):
        jb = first if step == 0 else next(jloader)
        tb = next(tloader)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        state, aux = jstep(state, jb, jax.random.PRNGKey(step))
        got = tstep(step, tb)
        for k in ("loss_heatmap", "loss_bbox", "grad_norm"):
            assert k in got and np.isfinite(float(got[k])), k
        jl.append(float(aux["loss"]))
        tl.append(float(got["loss"]))
    jl, tl = np.asarray(jl), np.asarray(tl)
    rel = np.abs(tl - jl) / np.abs(jl)
    print(f"twin losses jax {jl} port {tl} max rel dev {rel.max():.2e}")
    assert abs(jl[-1] - jl[0]) > 0.05 * jl[0]     # the weights moved
    assert rel.max() <= 6e-3, rel
    final = convert.state_dict_to_flax(
        {n: p for n, p in tmodel.named_parameters()})
    flat_ref = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, state.params))[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(final)[0])
    worst = max(float(np.abs(flat_got[p] - r).max()) for p, r in flat_ref)
    print(f"twin final params max abs diff {worst:.2e}")
    # at the peak rate the run is chaotic: JAX against itself from an init
    # perturbed by 1e-6 relative parts by 4.3e-2 in its parameters and 6%
    # in its fifth loss, so the losses carry the bar; the parameters stay
    # within AdamW's envelope, two runs at most 2 lr apart per step
    lr_sum = sum(schedule(s) for s in range(TWIN_STEPS))
    assert worst <= 2 * lr_sum


def test_cli_trains_and_evaluates_on_the_cpu(frames, tmp_path):
    info, root = frames
    work = str(tmp_path / "work")
    seen = []
    argv = ["centerpoint", "--infos", info, "--data-root", root,
            "--total-steps", str(CLI_STEPS), "--log-interval", "1",
            "--work-dir", work, "--tiny", "--device", "cpu"]
    assert ttrain.main(argv, hooks=[lambda s, m: seen.append(m)]) == \
        CLI_STEPS
    assert len(seen) == CLI_STEPS
    rows = [json.loads(line) for line in open(os.path.join(
        work, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == list(range(1, CLI_STEPS + 1))
    for r in rows:
        assert all(np.isfinite(r[k]) for k in
                   ("loss", "loss_heatmap", "loss_bbox", "grad_norm"))
    ckpt = torch.load(os.path.join(work, "ckpt", f"step_{CLI_STEPS}.pt"),
                      weights_only=True)
    init = ttrain.build_detector("centerpoint", tiny=True, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    same = {n for n, p in init.state_dict().items()
            if torch.equal(p, ckpt["model"][n])}
    # the velocity branch's code weights are 0: its norm and bias get no
    # gradient and no weight decay
    assert same == {"head.task0.GroupNorm_6.weight",
                    "head.task0.GroupNorm_6.bias", "head.task0.vel_out.bias"}
    # --dtype sets encoder_dtype, which the gather layout does not read
    assert ttrain.centerpoint_train_config(
        True, "bfloat16").encoder_dtype == "bfloat16"

    flags = ["centerpoint", "--infos", info, "--data-root", root,
             "--ckpt-dir", os.path.join(work, "ckpt"), "--tiny",
             "--device", "cpu", "--score-thresh", "0.0"]
    kitti = tcli.main(flags + ["--metric", "kitti"])
    shown = {k: v for k, v in kitti.items() if "_3d_" in k}
    assert len(shown) == 3 and all(0.0 <= v <= 100.0 for v in shown.values())
    waymo = tcli.main(flags + ["--metric", "waymo", "--out-dir",
                               str(tmp_path / "waymo")])
    assert "OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/mAP" in waymo
    assert os.path.getsize(tmp_path / "waymo" / "pred.bin") > 0
