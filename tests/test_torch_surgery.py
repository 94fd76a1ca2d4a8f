"""Checkpoint surgery of the port (``training/surgery.py``,
``tools/publish_model.py``) against the JAX package's
``training/surgery.py`` on the same weights: the content hash, publish and
restore, ``transplant``'s report (the string-prefix rule and a shape
mismatch), and the CLI end to end with ``tools/train.py`` resuming from the
transplanted checkpoint at step 0."""
import json
import os

import numpy as np
import torch

from objectcentricocccompletion_tpu.training import surgery as jsurgery
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.configs.ococcnet_config import (
    tiny_config)
from objectcentricocccompletion_torch.data import loader as tloader
from objectcentricocccompletion_torch.models.fsd import FSD, tiny_fsd_config
from objectcentricocccompletion_torch.models.ococcnet import OcOccNetWithLoss
from objectcentricocccompletion_torch.models.sst_detector import (
    SSTDetector, tiny_sst_detector_config)
from objectcentricocccompletion_torch.parallel.train import (
    create_train_state)
from objectcentricocccompletion_torch.tools import publish_model
from objectcentricocccompletion_torch.tools import train as tcli
from objectcentricocccompletion_torch.training import surgery
from objectcentricocccompletion_torch.training.trainer import (
    CheckpointManager)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _ctrl_with_segmentor():
    cfg = tcli.ococc_train_config("ctrl", tiny=True)
    cfg = type(cfg)(**{**cfg.__dict__, "use_segmentor": "tiny"})
    return OcOccNetWithLoss(cfg, "cpu", _gen(1))


def test_tree_hash_equals_the_jax_package():
    """The JAX hash of each model's flax tree (SST's renamed layers and
    mirrored transposed convolutions, OcOccNet, FSD's UNet) equals the
    port's hash of the state dict that ``convert`` makes of it; a changed
    byte changes it."""
    for model in (SSTDetector(tiny_sst_detector_config(), "cpu", _gen()),
                  OcOccNetWithLoss(tiny_config(), "cpu", _gen()),
                  FSD(tiny_fsd_config(), "cpu", _gen())):
        tree = convert.state_dict_to_flax(model.state_dict())
        sd = convert.flax_to_state_dict(tree)
        assert surgery.tree_hash(sd) == jsurgery.tree_hash(tree)
        assert surgery.tree_hash(model.state_dict()) == \
            jsurgery.tree_hash(tree)
        name = next(iter(sd))
        sd[name] = sd[name].clone()
        sd[name].view(-1)[0] += 1.0
        assert surgery.tree_hash(sd) != jsurgery.tree_hash(tree)


def test_publish_strips_the_optimizer_and_restore_reads_both(tmp_path):
    cfg = tiny_config()
    model, optimizer, _ = create_train_state(cfg, 10, "cpu")
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(7, model, optimizer)
    (tmp_path / "ckpt" / "config.json").write_text('{"tiny": true}')
    out = surgery.publish(str(tmp_path / "ckpt"), str(tmp_path / "rel"))
    digest = surgery.tree_hash(model.state_dict())
    assert out == f"{tmp_path / 'rel'}-{digest[:8]}"
    assert json.load(open(os.path.join(out, "PUBLISH.json"))) == {
        "sha256": digest, "source_step": 7}
    assert open(os.path.join(out, "config.json")).read() == '{"tiny": true}'
    state = torch.load(os.path.join(out, "step_7.pt"))
    assert set(state) == {"step", "model"}
    for src in (tmp_path / "ckpt", out):
        step, params = surgery.restore_params(str(src))
        assert step == 7 and set(params) == set(model.state_dict())
        for n, p in model.state_dict().items():
            assert torch.equal(params[n], p)
    # publishing the published checkpoint keeps the hash
    assert surgery.publish(out, str(tmp_path / "again")) == \
        f"{tmp_path / 'again'}-{digest[:8]}"
    again = surgery.publish(str(tmp_path / "ckpt"), str(tmp_path / "r0"),
                            keep_step=False)
    assert surgery.restore_params(again)[0] == 0
    fresh = OcOccNetWithLoss(cfg, "cpu", _gen(5))
    _, opt2, _ = create_train_state(cfg, 10, "cpu", seed=5)
    assert CheckpointManager(out).restore(fresh, opt2) == 7
    assert not opt2.state


def test_transplant_report_equals_the_jax_package():
    """FSD's ``vfe`` / ``unet`` into CTRL's segmentor: the JAX report on
    the flax trees, mapped through ``convert``'s names, equals the port's
    on the state dicts. The prefix is a plain string prefix (``vfe`` also
    takes a ``vfe2`` subtree, whose names have no target), and one source
    tensor of another shape is reported and not copied."""
    fsd = convert.state_dict_to_flax(
        FSD(tiny_fsd_config(), "cpu", _gen()).state_dict())
    fsd["vfe2"] = {"Dense_0": {"kernel": np.ones((3, 4), np.float32)}}
    first = next(iter(fsd["vfe"]))
    fsd["vfe"][first]["kernel"] = np.zeros((2, 5), np.float32)
    dst = convert.state_dict_to_flax(_ctrl_with_segmentor().state_dict())

    def names(tree):
        paths = ["/".join(p) for p, _ in jsurgery._flatten(tree)]
        sd = convert.flax_to_state_dict(tree)
        return dict(zip(paths, sd)), sd

    src_names, src_sd = names(fsd)
    dst_names, dst_sd = names(dst)
    for prefixes in (("vfe", "net/segmentor/vfe"),
                     ("unet/", "net/segmentor/unet/")):
        new, jrep = jsurgery.transplant(dst, fsd, *prefixes)
        tprefixes = [p.replace("/", ".") for p in prefixes]
        tnew, rep = surgery.transplant(dst_sd, src_sd, *tprefixes)
        assert rep["copied"] == [dst_names[n] for n in jrep["copied"]]
        assert rep["missing"] == [src_names[n] for n in jrep["missing"]]
        assert rep["shape_mismatch"] == [
            (src_names[n], tuple(src_sd[src_names[n]].shape),
             tuple(dst_sd[dst_names[prefixes[1] + n[len(prefixes[0]):]]]
                   .shape)) for n, _, _ in jrep["shape_mismatch"]]
        assert rep["copied"]
        new_sd = convert.flax_to_state_dict(new)
        for n in rep["copied"]:
            assert torch.equal(tnew[n], new_sd[n])
        untouched = set(dst_sd) - set(rep["copied"])
        assert all(tnew[n] is dst_sd[n] for n in untouched)
    _, rep = surgery.transplant(dst_sd, src_sd, "vfe", "net.segmentor.vfe")
    assert rep["missing"] == ["vfe2.Dense_0.weight"]
    assert f"vfe.{first}.weight" in [m[0] for m in rep["shape_mismatch"]]


def test_cli_publishes_transplants_and_train_resumes_at_step_0(tmp_path,
                                                              capsys):
    """Two one-step runs (seeds 0 and 1); publish the second; transplant
    its RoI encoder into the first's checkpoint; ``tools/train.py``
    resumes from the result at step 0 with a fresh AdamW."""
    paths = tloader.write_synthetic_dataset(str(tmp_path / "data"),
                                            num_tracklets=4, track_len=12,
                                            seed=2)
    flags = ["--proposals", paths["proposals_file"], "--gt-candidates",
             paths["gt_candidates_file"], "--poses", paths["pose_file"],
             "--occ-root", paths["occ_anno_root"], "--tiny", "--device",
             "cpu", "--log-interval", "1"]
    for seed in (0, 1):
        assert tcli.main(["ococcnet", *flags, "--total-steps", "1",
                          "--seed", str(seed), "--work-dir",
                          str(tmp_path / f"w{seed}")]) == 1
    rel = publish_model.main(["publish", str(tmp_path / "w1" / "ckpt"),
                              "--out", str(tmp_path / "rel")])
    out = str(tmp_path / "w2" / "ckpt")
    publish_model.main(["transplant", rel, str(tmp_path / "w0" / "ckpt"),
                        "--out", out, "--src-prefix", "net.roi_encoder.",
                        "--dst-prefix", "net.roi_encoder."])
    printed = capsys.readouterr().out
    _, src = surgery.restore_params(rel)
    _, dst = surgery.restore_params(str(tmp_path / "w0" / "ckpt"))
    n_enc = sum(n.startswith("net.roi_encoder.") for n in src)
    assert f"copied {n_enc} leaves; 0 missing; 0 shape mismatches" in printed
    state = torch.load(os.path.join(out, "step_0.pt"))
    assert set(state) == {"step", "model"} and state["step"] == 0
    for n, p in state["model"].items():
        assert torch.equal(p, (src if n.startswith("net.roi_encoder.")
                               else dst)[n]), n
    assert tcli.main(["ococcnet", *flags, "--total-steps", "1",
                      "--work-dir", str(tmp_path / "w2")]) == 1
    rows = [json.loads(line)
            for line in open(tmp_path / "w2" / "metrics.jsonl")]
    # a step ran from step 0 (a restore at step 1 would run none)
    assert [r["step"] for r in rows] == [1]
    resumed = torch.load(tmp_path / "w2" / "ckpt" / "step_1.pt")
    assert resumed["step"] == 1 and "optimizer" in resumed
