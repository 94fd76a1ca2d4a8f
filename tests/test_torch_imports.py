"""The port and ``chip_smoke.py`` import neither JAX, flax nor the JAX
package: the port keeps its own copy of everything it needs."""
import pathlib
import re

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
            "synthetic.py", "tracklet.py"} <= names
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
