"""The port's benchmark CLI on trained weights and at another batch
(``tools/benchmark.py``: ``--ckpt-dir``, ``--batch``) on the CPU: the
OcOccNet benchmark at batch 2 on a ``--tiny`` checkpoint of
``tools/train.py`` published by ``tools/publish_model.py``, named by the
JAX package's ``training/surgery.py::tree_hash`` of the same weights; a
frame detector on its ``tools/train.py --tiny`` checkpoint against a model
given the same state dict directly; the CLI's refusals, which exit before a
model is built; a checkpoint of another config refused at the strict load.

A file of at most four tests (pytest-xdist's ``--dist loadfile``; see
``test_torch_centerpoint.py``)."""
import dataclasses
import json
import os

import pytest

from objectcentricocccompletion_tpu.training import surgery as jsurgery
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.configs.ococcnet_config import (
    tiny_config)
from objectcentricocccompletion_torch.data import loader as tloader
from objectcentricocccompletion_torch.data.frame_dataset import (
    write_synthetic_frames)
from objectcentricocccompletion_torch.evalx.detector_eval import (
    make_predict_fn)
from objectcentricocccompletion_torch.tools import benchmark as bench
from objectcentricocccompletion_torch.tools import publish_model
from objectcentricocccompletion_torch.tools import train as tcli
from objectcentricocccompletion_torch.training import surgery
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TRAIN_STEPS = 2
FRAME_POINTS = 3000


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """A ``tools/train.py ococcnet --tiny`` checkpoint of ``TRAIN_STEPS``
    steps and its ``tools/publish_model.py publish`` release:
    (training checkpoint directory, release directory)."""
    root = tmp_path_factory.mktemp("occ")
    paths = tloader.write_synthetic_dataset(str(root / "data"),
                                            num_tracklets=4, track_len=12,
                                            seed=1)
    work = str(root / "work")
    assert tcli.main([
        "ococcnet", "--proposals", paths["proposals_file"],
        "--gt-candidates", paths["gt_candidates_file"], "--poses",
        paths["pose_file"], "--occ-root", paths["occ_anno_root"], "--tiny",
        "--device", "cpu", "--total-steps", str(TRAIN_STEPS),
        "--work-dir", work]) == TRAIN_STEPS
    ckpt = os.path.join(work, "ckpt")
    return ckpt, publish_model.main(["publish", ckpt, "--out",
                                     str(root / "release")])


def test_ococcnet_bench_at_batch_2_on_the_published_checkpoint(published):
    """``bench_ococcnet(cfg=tiny_config(), batch=2)`` on the release: 2
    tracklets per call in every output, the checkpoint's step, and a
    ``params_hash`` equal to ``PUBLISH.json``'s and to the JAX package's
    ``tree_hash`` of the flax tree of the same weights; the training
    checkpoint gives the same hash; the seeded init names no weights."""
    ckpt, release = published
    step, sd = surgery.restore_params(release)
    jax_hash = jsurgery.tree_hash(convert.state_dict_to_flax(sd))
    res = bench.bench_ococcnet(1, "float32", device="cpu",
                               cfg=tiny_config(), batch=2,
                               ckpt_dir=release)
    assert res["ckpt_step"] == step == TRAIN_STEPS
    assert res["params_hash"] == jax_hash == json.load(open(
        os.path.join(release, "PUBLISH.json")))["sha256"]
    assert res["batch"] == 2 and res["finite"]
    assert {k: v[0] for k, v in res["shapes"].items()} == {
        k: 2 for k in res["shapes"]}
    assert "occ_logits" in res["shapes"]
    assert json.loads(json.dumps(res)) == res
    res = bench.bench_ococcnet(1, "float32", device="cpu",
                               cfg=tiny_config(), batch=2, ckpt_dir=ckpt)
    assert (res["ckpt_step"], res["params_hash"]) == (TRAIN_STEPS, jax_hash)
    res = bench.bench_ococcnet(1, "float32", device="cpu",
                               cfg=tiny_config(), batch=2)
    assert res["ckpt_step"] is None and res["params_hash"] is None


def test_frame_bench_on_the_trained_checkpoint(tmp_path):
    """``tools/train.py sst --tiny`` writes a checkpoint; ``bench_sst`` on
    it at the tiny config gives the outputs (shapes, valid count, sums)
    of a model given the checkpoint's state dict directly, which differ
    from the seeded init's, and names its step and hash."""
    data = str(tmp_path / "frames")
    # inside the tiny config's +-9.6 m range
    infos = write_synthetic_frames(data, num_frames=2,
                                   num_points=FRAME_POINTS, num_boxes=6,
                                   seed=0, xy_range=9.0)
    work = str(tmp_path / "work")
    assert tcli.main(["sst", "--infos", infos, "--data-root", data,
                      "--total-steps", "1", "--work-dir", work, "--tiny",
                      "--device", "cpu"]) == 1
    ckpt = os.path.join(work, "ckpt")
    cfg = tcli.build_detector("sst", tiny=True, device="cpu").cfg
    kw = dict(dtype="float32", device="cpu", num_real=FRAME_POINTS,
              cfg=cfg)
    res = bench.bench_sst(1, ckpt_dir=ckpt, **kw)
    step, sd = surgery.restore_params(ckpt)
    assert res["ckpt_step"] == step == 1
    assert res["params_hash"] == surgery.tree_hash(sd)
    model = bench.build_sst(bench.sst_config("float32", cfg), "cpu", seed=1)
    model.load_state_dict(sd)
    points, mask = bench.frame_tensors(cfg, "cpu", FRAME_POINTS, seed=0)
    direct = bench.frame_outputs(make_predict_fn(model, "sst")(points, mask))
    assert res["outputs"] == direct and direct["finite"]
    assert direct["shapes"][0] == [500, 7]
    assert res["predict_calls"] == 3
    init = bench.bench_sst(1, **kw)
    assert init["outputs"] != direct
    assert init["ckpt_step"] is None and init["params_hash"] is None


def test_cli_refusals_exit_before_a_model(monkeypatch):
    """``--batch`` on a frame family, ``--ckpt-dir`` with ``--train`` or
    on ``annotate``: ``SystemExit`` naming the flag, no model built."""
    def built(*args, **kw):
        raise AssertionError("a model was built")

    for name in ("build_sst", "build_frame_detector", "build_ococcnet",
                 "build_votenet", "create_train_state", "bench_annotate"):
        monkeypatch.setattr(bench, name, built)
    for argv, flag in ((["sst", "--batch", "2"], "--batch"),
                       (["centerpoint", "--batch", "8"], "--batch"),
                       (["votenet", "--batch", "2"], "--batch"),
                       (["ococcnet", "--train", "--ckpt-dir", "w"],
                        "--ckpt-dir"),
                       (["sst", "--train", "--ckpt-dir", "w"], "--ckpt-dir"),
                       (["annotate", "--ckpt-dir", "w"], "--ckpt-dir")):
        with pytest.raises(SystemExit) as e:
            bench.main(argv + ["--device", "cpu"])
        assert flag in str(e.value.code), argv


def test_checkpoint_of_another_config_raises_at_the_strict_load(published):
    """The tiny OcOccNet release into CTRL (no decoder: unexpected keys) and
    into a wider OcOccNet (sizes) raises; nothing loads loosely."""
    _, release = published
    for cfg, words in (
            (tcli.ococc_train_config("ctrl", tiny=True), "Unexpected key"),
            (dataclasses.replace(tiny_config(), d_model=256), "size")):
        with pytest.raises(RuntimeError, match=words):
            bench.bench_ococcnet(1, "float32", device="cpu", cfg=cfg,
                                 batch=2, ckpt_dir=release)
    with pytest.raises(FileNotFoundError):
        bench.bench_ococcnet(1, "float32", device="cpu", cfg=tiny_config(),
                             ckpt_dir=os.path.dirname(release))
