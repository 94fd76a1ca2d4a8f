"""FSD training and evaluation in the port against the JAX package on the
CPU: a twin run of two-stage FSD at ``tiny_two_stage_config()`` (one
converted init, the same batches of the same synthetic frames, the JAX
``make_detector_train_step`` against the port's) tracks the JAX losses to
the repository's twin bar (6e-3 relative); then ``tools/train.py fsd`` and
``fsd2 --tiny --device cpu`` train and checkpoint, and ``tools/test.py``
evaluates each checkpoint with the KITTI and the Waymo metrics.

A file of at most four tests (pytest-xdist's ``--dist loadfile``; see
``test_torch_fsd.py``)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.data import frame_dataset as jfd
from objectcentricocccompletion_tpu.models import fsd_two_stage as jts
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
from tests.test_torch_fsd import random_params
from tests.test_torch_fsd_two_stage import (TINY2, param_tree,
                                            torch_two_stage)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TWIN_STEPS = 5
# base_lr of the twin (peak 100x after the first step). Above it the run
# is chaotic in JAX itself: from an init perturbed by 1e-6 relative, JAX's
# own losses part by 27% at step 4 at 1e-4, by 6.8e-3 at step 5 at 1e-5 and
# by 2.1e-2 at step 4 at 3e-6; at 1e-6 by 2.1e-6. A flipped grouping (a
# score rank, a voxel boundary) moves whole clusters, and Adam's first
# moves turn gradients near 0 into lr-sized steps of either sign.
TWIN_LR = 1e-6
# frames inside the tiny config's +-9.6 m range
FRAMES = dict(num_frames=3, num_points=3000, num_boxes=8, xy_range=8.0)
CLI_STEPS = 3


class JaxTwoStageWithLoss(jts.TwoStageFSD):
    """The JAX CLI's training model: the forward and ``two_stage_loss``."""

    def loss(self, points, mask, gt_boxes, gt_labels, gt_valid):
        return jts.two_stage_loss(self(points, mask), points, gt_boxes,
                                  gt_labels, gt_valid)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fsd_frames"))
    return tfd.write_synthetic_frames(root, seed=9, **FRAMES), root


def test_two_stage_twin_training(frames):
    """Five steps of one frame each at base_lr ``TWIN_LR`` from one
    converted init on the same batches."""
    info, root = frames
    kw = dict(max_points=TINY2.fsd.max_points, max_gt=8)
    jloader = jdt.FrameLoader(jfd.FrameDataset(info, root, **kw), 1, seed=1)
    tloader = tdt.FrameLoader(tfd.FrameDataset(info, root, **kw), 1, seed=1)

    model = JaxTwoStageWithLoss(TINY2)
    first = next(jloader)
    params = random_params(param_tree(), 3)
    tx, _ = jax_make_optimizer(TWIN_LR, TWIN_STEPS)
    mesh = make_mesh(jax.devices()[:1])
    state = jax.device_put(jdt.DetectorState(
        jnp.zeros((), jnp.int32), params, jax.jit(tx.init)(params)),
        replicated(mesh))
    jstep = jdt.make_detector_train_step(model, tx, mesh)

    tmodel = torch_two_stage(params).train()
    init = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    opt, schedule = make_optimizer(tmodel.named_parameters(), TWIN_LR,
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
        for k in ("loss_seg", "loss_cls2", "loss_corner2", "grad_norm"):
            assert k in got and np.isfinite(float(got[k])), k
        jl.append(float(aux["loss"]))
        tl.append(float(got["loss"]))
    jl, tl = np.asarray(jl), np.asarray(tl)
    rel = np.abs(tl - jl) / np.abs(jl)
    print(f"twin losses jax {jl} port {tl} max rel dev {rel.max():.2e}")
    assert rel.max() <= 6e-3, rel
    final = convert.state_dict_to_flax(
        {n: p for n, p in tmodel.named_parameters()})
    flat_ref = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, state.params))[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(final)[0])
    worst = max(float(np.abs(flat_got[p] - r).max()) for p, r in flat_ref)
    print(f"twin final params max abs diff {worst:.2e}")
    # the weights moved, and the two runs stay within AdamW's envelope, at
    # most 2 lr apart per step
    lr_sum = sum(schedule(s) for s in range(TWIN_STEPS))
    moved = max(float((p.detach() - init[n]).abs().max())
                for n, p in tmodel.named_parameters())
    print(f"twin largest move {moved:.2e} (lr sum {lr_sum:.2e})")
    assert moved > 0.5 * lr_sum
    assert worst <= 2 * lr_sum


# the parameters that a few tiny steps on these frames may leave as they
# were: with no cluster of a class in a GT box of its class, that task's
# centre, size and rotation branches get no gradient, nor stage 2's
# regression head with no proposal over its IoU threshold; their norms and
# biases take no weight decay
REGRESSION = ("_center.", "_dim.", "_rot.", "conv_reg.")
@pytest.mark.parametrize("family", ["fsd", "fsd2"])
def test_cli_trains_and_evaluates_on_the_cpu(frames, tmp_path, family):
    info, root = frames
    work = str(tmp_path / "work")
    seen = []
    argv = [family, "--infos", info, "--data-root", root,
            "--total-steps", str(CLI_STEPS), "--log-interval", "1",
            "--work-dir", work, "--tiny", "--device", "cpu"]
    assert ttrain.main(argv, hooks=[lambda s, m: seen.append(m)]) == \
        CLI_STEPS
    assert len(seen) == CLI_STEPS
    keys = ("loss", "loss_seg", "loss_vote", "loss_cls", "grad_norm") + (
        ("loss_cls2", "loss_reg2", "loss_corner2") if family == "fsd2"
        else ())
    rows = [json.loads(line) for line in open(os.path.join(
        work, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == list(range(1, CLI_STEPS + 1))
    for r in rows:
        assert all(np.isfinite(r[k]) for k in keys), r
    ckpt = torch.load(os.path.join(work, "ckpt", f"step_{CLI_STEPS}.pt"),
                      weights_only=True)
    init = ttrain.build_detector(family, tiny=True, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    same = {n for n, p in init.state_dict().items()
            if torch.equal(p, ckpt["model"][n])}
    assert all(any(r in n for r in REGRESSION)
               and (n.endswith("bias") or "LayerNorm" in n)
               for n in same), sorted(same)
    # --dtype reaches the compute dtype (the single-stage sub-config's)
    assert ttrain.build_detector(family, True, "bfloat16", "cpu").cfg == (
        ttrain.fsd_train_config(True, "bfloat16") if family == "fsd" else
        ttrain.fsd2_train_config(True, "bfloat16"))
    assert ttrain.fsd2_train_config(True, "bfloat16").fsd.compute_dtype \
        == "bfloat16"

    flags = [family, "--infos", info, "--data-root", root,
             "--ckpt-dir", os.path.join(work, "ckpt"), "--tiny",
             "--device", "cpu", "--score-thresh", "0.0"]
    kitti = tcli.main(flags + ["--metric", "kitti"])
    shown = {k: v for k, v in kitti.items() if "_3d_" in k}
    assert len(shown) == 3 and all(0.0 <= v <= 100.0 for v in shown.values())
    waymo = tcli.main(flags + ["--metric", "waymo", "--out-dir",
                               str(tmp_path / "waymo")])
    assert "OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/mAP" in waymo
    assert os.path.getsize(tmp_path / "waymo" / "pred.bin") > 0
