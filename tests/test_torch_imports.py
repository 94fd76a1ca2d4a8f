"""The port and ``chip_smoke.py`` import neither JAX, flax nor the JAX
package: the port keeps its own copy of everything it needs."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|"
    r"objectcentricocccompletion_tpu)\b", re.M)


def _sources():
    files = sorted((ROOT / "objectcentricocccompletion_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_sources_exist():
    names = {p.name for p in _sources()}
    assert {"chip_smoke.py", "window_attention.py", "sst.py",
            "convert.py", "anchor_head.py", "detector_trainer.py",
            "optim.py", "trainer.py", "frame_dataset.py", "train.py",
            "benchmark.py", "ococcnet_config.py", "boxes.py", "coder.py",
            "roi_pool.py", "masked.py", "packed.py", "layers.py", "sir.py",
            "transformer.py", "occ_decoder.py", "ococcnet.py",
            "synthetic.py", "tracklet.py", "tracklet_dataset.py",
            "np_geometry.py", "loader.py", "evaluator.py", "occ_iou.py",
            "tta.py", "online_tuning.py", "waymo_bin.py", "waymo_metrics.py",
            "submission.py", "kitti_eval.py", "detector_eval.py", "test.py",
            "create_submission.py", "sparse_conv.py", "sparse_encoder.py",
            "second.py", "centerpoint_head.py", "centerpoint.py",
            "cluster.py", "fsd.py", "fsd_two_stage.py", "incremental.py",
            "seeds.py", "fsdpp.py", "seed_store.py", "routes.py",
            "seq_trainer.py", "annotate.py", "range_image.py",
            "waymo_raw_converter.py", "scenes.py", "generate_tracklets.py",
            "extend_tracks.py", "create_data.py", "dbsampler.py",
            "hooks.py", "tracklet_segmentor.py", "votenet.py", "pointnet.py",
            "nuscenes_dataset.py", "indoor_dataset.py",
            "argo2_dataset.py", "surgery.py", "publish_model.py",
            "export.py", "multihost.py", "sp.py", "collectives.py",
            "column_conv.py", "profiling.py"} <= names
    for sub in ("tools_occ", "tools_ctrl"):
        assert (ROOT / "objectcentricocccompletion_torch" / sub /
                "__init__.py").exists()
    for name in ("train.py", "sp.py"):
        assert (ROOT / "objectcentricocccompletion_torch" / "parallel" /
                name).exists()
    csrc = ROOT / "objectcentricocccompletion_torch" / "csrc"
    assert {"window_attention.cu", "window_attention_bwd.cu"} <= \
        {p.name for p in csrc.glob("*.cu")}


def test_port_imports_no_jax():
    offenders = []
    for path in _sources():
        for m in FORBIDDEN.finditer(path.read_text()):
            line = path.read_text()[:m.start()].count("\n") + 1
            offenders.append(f"{path.relative_to(ROOT)}:{line}")
    assert not offenders, offenders


def test_port_modules_import_without_the_jax_package():
    """Every module of the port, imported in a fresh interpreter that
    cannot import JAX, flax, optax or the JAX package, leaves none of them
    in ``sys.modules``; nor pandas or pyarrow, which the card's machine
    lacks (the Argoverse 2 reader imports them where it reads a file)."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "objectcentricocccompletion_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "BLOCKED = {'jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "           'objectcentricocccompletion_tpu', 'pandas', 'pyarrow'}\n"
        "for m in list(sys.modules):\n"
        "    if m.split('.')[0] in BLOCKED:\n"
        "        del sys.modules[m]\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in BLOCKED))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    assert "objectcentricocccompletion_torch.parallel.train" in modules
    assert "objectcentricocccompletion_torch.evalx.evaluator" in modules
    assert "objectcentricocccompletion_torch.tools.test" in modules
    assert "objectcentricocccompletion_torch.models.fsdpp" in modules
    assert "objectcentricocccompletion_torch.training.seq_trainer" in \
        modules
    assert "objectcentricocccompletion_torch.models.centerpoint" in modules
    assert "objectcentricocccompletion_torch.data.argo2_dataset" in modules
    assert "objectcentricocccompletion_torch.models.votenet" in modules
    for name in ("training.surgery", "tools.publish_model",
                 "serving.export", "parallel.multihost", "ops.column_conv",
                 "utils.profiling"):
        assert f"objectcentricocccompletion_torch.{name}" in modules
