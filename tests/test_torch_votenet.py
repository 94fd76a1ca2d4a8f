"""The port's VoteNet held against the JAX package on the CPU, at
``tiny_votenet_config()`` in the ScanNet (axis-aligned) and the SUN RGB-D
(yawed) forms, and driven through the CLIs on the indoor readers' files.

Inputs come from a numpy seed; weights cross over through ``convert.py``
(the flax names ``sa{i}/mlp``, ``fp{j}/mlp``, ``vote``, ``agg``, ``head``
are the port's module paths). The furthest point samples and ball-query
memberships must equal JAX's (both run the same float32 operations, so no
pick lies within a rounding step of a tie on these inputs). Bars: the
forward's float32 outputs within 2e-5 absolute; the losses within 2e-5;
every gradient within 1e-4.

A file of at most four tests (pytest-xdist's ``--dist loadfile`` hands out
the files with the most tests first)."""
import dataclasses
import functools
import json

import jax
import numpy as np
import torch

from objectcentricocccompletion_tpu.evalx import detector_eval as jeval
from objectcentricocccompletion_tpu.models import votenet as jvote
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.evalx import detector_eval as teval
from objectcentricocccompletion_torch.models import votenet as tvote
from objectcentricocccompletion_torch.ops.routes import Routes
from objectcentricocccompletion_torch.tools import test as test_cli
from objectcentricocccompletion_torch.tools import train as train_cli
from tests.test_indoor_dataset import write_scannet_fixture
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
LOSS_TOL = 2e-5
GRAD_TOL = 1e-4
# 64 proposals and positives within 0.8 m, so that the tiny model's random
# proposals include positives and every loss term takes part
_TINY = dataclasses.replace(jvote.tiny_votenet_config(), num_proposals=64,
                            pos_dist=0.8, neg_dist=1.6)
FORMS = {"scannet": _TINY,
         "sunrgbd": dataclasses.replace(_TINY, with_yaw=True)}
OUT_KEYS = ("seed_xyz", "seed_mask", "vote_xyz", "obj", "boxes", "sem",
            "proposal_mask")


def make_room(cfg, seed=0, num_boxes=6, max_gt=8):
    """A room of uniform clutter with ``num_boxes`` dense objects (the JAX
    package's ``tests/test_votenet.py`` room, in numpy), 40 slots masked."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 8, (cfg.max_points - 100 * num_boxes, 3))
    boxes = []
    for _ in range(num_boxes):
        ctr = rng.uniform(2, 6, 3)
        size = np.abs(rng.normal([0.8, 0.8, 0.9], 0.05))
        yaw = rng.uniform(-1, 1) if cfg.with_yaw else 0.0
        boxes.append(np.concatenate([ctr[:2], [ctr[2] - size[2] / 2],
                                     size, [yaw]]))
        pts = np.concatenate([pts, (rng.rand(100, 3) - 0.5) * size + ctr])
    points = np.concatenate([pts, rng.rand(len(pts), 3)], -1).astype(
        np.float32)
    mask = np.ones(len(points), bool)
    mask[rng.choice(len(points), 40, replace=False)] = False
    gt_boxes = np.zeros((max_gt, 7), np.float32)
    gt_boxes[:num_boxes] = boxes
    gt_labels = np.zeros((max_gt,), np.int32)
    gt_labels[:num_boxes] = rng.randint(0, cfg.num_classes, num_boxes)
    return points, mask, gt_boxes, gt_labels, np.arange(max_gt) < num_boxes


@functools.lru_cache(maxsize=None)
def _jax(form):
    """The JAX model, its initialised parameters and the jitted forward,
    loss + gradient and predict."""
    cfg = FORMS[form]
    model = jvote.VoteNet(cfg)
    points, mask, *_ = make_room(cfg)
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(1),
                                                points, mask)["params"])
    fwd = jax.jit(lambda p, x, m: model.apply({"params": p}, x, m))
    loss = jax.jit(jax.value_and_grad(
        lambda p, *b: model.apply({"params": p}, *b, method=jvote.VoteNet.loss
                                  )["loss"], has_aux=False))
    terms = jax.jit(lambda p, *b: model.apply({"params": p}, *b,
                                              method=jvote.VoteNet.loss))
    return model, params, fwd, loss, terms


def _port(form, params):
    cfg = tvote.VoteNetConfig(**dataclasses.asdict(FORMS[form]))
    model = tvote.VoteNet(cfg, "cpu")
    model.load_state_dict(convert.flax_to_state_dict(params))
    return model


def test_forward_matches_in_both_forms():
    """Every output of the forward, ScanNet and SUN RGB-D; the recorded
    picks: per set abstraction and for the proposals a furthest point
    sampling and a ball query (its kNN and its membership), and the
    feature propagation's kNN."""
    for form in FORMS:
        _, params, fwd, _, _ = _jax(form)
        points, mask, *_ = make_room(FORMS[form])
        ref = jax.device_get(fwd(params, points, mask))
        model = _port(form, params)
        with torch.no_grad(), Routes() as picks:
            out = model(torch.from_numpy(points), torch.from_numpy(mask))
        assert len(picks.masks) == 2 * 3 + 1 + 3
        for k in OUT_KEYS:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       atol=FWD_TOL, rtol=0, err_msg=k)
        assert out["proposal_mask"].all()
        if form == "sunrgbd":
            assert out["boxes"][:, 6].abs().max() > 0.1


def test_losses_and_every_gradient_match():
    """The loss terms and every parameter's gradient, both forms, on rooms
    with positive proposals."""
    for form in FORMS:
        _, params, _, loss, terms = _jax(form)
        batch = make_room(FORMS[form], seed=2)
        ref_terms = jax.device_get(terms(params, *batch))
        _, ref_grads = loss(params, *batch)
        model = _port(form, params)
        got = model.loss(*(torch.from_numpy(b) for b in batch))
        got["loss"].backward()
        assert set(got) == set(ref_terms)
        for k, r in ref_terms.items():
            np.testing.assert_allclose(float(got[k].detach()), float(r),
                                       atol=LOSS_TOL, rtol=0, err_msg=k)
        assert float(ref_terms["num_pos"]) > 0
        grads = convert.flax_to_state_dict(jax.device_get(ref_grads))
        named = dict(model.named_parameters())
        assert set(grads) == set(named)
        for k, g in grads.items():
            np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                       atol=GRAD_TOL, rtol=0, err_msg=k)
        assert sum(float(g.abs().max()) > 1e-3 for g in grads.values()) > \
            len(grads) // 2


def test_make_predict_fn_matches():
    """``make_predict_fn(model, "votenet")``: boxes, sigmoid(objectness) x
    proposal mask, the best class, the proposal mask."""
    model_j, params, _, _, _ = _jax("sunrgbd")
    points, mask, *_ = make_room(FORMS["sunrgbd"], seed=3)
    ref = jeval.make_predict_fn(model_j, "votenet")(params, points, mask)
    got = teval.make_predict_fn(_port("sunrgbd", params), "votenet")(
        torch.from_numpy(points), torch.from_numpy(mask))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), r)
        else:
            np.testing.assert_allclose(g.numpy(), r, atol=FWD_TOL, rtol=0)


def test_cli_train_and_test_on_scannet_files(tmp_path, capsys):
    """``tools/train.py votenet --dataset scannet`` for 3 steps and
    ``tools/test.py votenet`` on its checkpoint, on the CPU, on the ScanNet
    files of the JAX package's reader test; then SUN RGB-D's yawed boxes
    through the test CLI's reader (18 ScanNet / 10 SUN RGB-D classes key
    the AP)."""
    info = write_scannet_fixture(str(tmp_path))
    work = str(tmp_path / "run")
    common = ["votenet", "--infos", info, "--data-root", str(tmp_path),
              "--tiny", "--device", "cpu"]
    done = train_cli.main(common + ["--dataset", "scannet", "--work-dir",
                                    work, "--total-steps", "3",
                                    "--log-interval", "1"])
    assert done == 3
    rows = [json.loads(line) for line in open(f"{work}/metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in rows)
    sd = torch.load(f"{work}/ckpt/step_3.pt", weights_only=True)["model"]
    assert sd["head.Dense_1.weight"].shape[0] == 7 + 4   # min(18, 4) classes
    capsys.readouterr()
    metrics = test_cli.main(common + ["--dataset", "scannet", "--ckpt-dir",
                                      f"{work}/ckpt", "--max-frames", "2"])
    assert "cabinet_3d_easy" in metrics and "garbagebin_3d_hard" in metrics
    assert all(0.0 <= v <= 100.0 for v in metrics.values())
    sun = write_scannet_fixture(str(tmp_path / "sun"), yawed=True)
    metrics = test_cli.main(["votenet", "--infos", sun, "--data-root",
                             str(tmp_path / "sun"), "--tiny", "--device",
                             "cpu", "--dataset", "sunrgbd", "--ckpt-dir",
                             f"{work}/ckpt", "--max-frames", "1"])
    assert len(metrics) == 3 * 10 and "night_stand_3d_moderate" in metrics
