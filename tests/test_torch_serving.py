"""The port's serving export (``serving/export.py``: a ``torch.export``
program of ``OcOccNetWithLoss.predict`` with the parameters as an
argument) on the CPU: the bundle against live predict and against the JAX
package's ``save_bundle`` / ``load_bundle`` on the same weights, one bundle
serving a second checkpoint, and a bundle loaded where the port's model
code cannot be imported."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from objectcentricocccompletion_tpu.serving import export as jexport
from objectcentricocccompletion_torch.models.ococcnet import OcOccNetWithLoss
from objectcentricocccompletion_torch.serving import (load_bundle,
                                                      save_bundle)
from tests.test_torch_ococcnet import (CONFIGS, OUT_KEYS, TINY, _batch,
                                       _jbatch, _params, _port_model,
                                       _torch_config)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 sums in another order than XLA's (the JAX package's parity bar
# for one jitted forward is 2e-4 at this size; the outputs here are
# O(1) or smaller)
JAX_TOL = 1e-5


def _live(model, batch):
    with torch.no_grad():
        return model.predict(batch)


def _assert_equal(got, ref):
    assert set(got) == set(OUT_KEYS) <= set(ref)
    for k in OUT_KEYS:
        assert torch.equal(got[k], ref[k]), k


def test_bundle_equals_live_predict_and_the_jax_bundle(tmp_path):
    """Dense (``tiny_config()``): the served outputs equal live predict's
    bit for bit and the JAX bundle's within ``JAX_TOL``; packed: equal to
    live predict."""
    params = _params("dense")
    model = _port_model(TINY, params)
    batch = _batch(TINY)
    out = save_bundle(str(tmp_path / "port"), _torch_config(TINY),
                      model.state_dict(), batch, device="cpu")
    bundle = load_bundle(out)
    served = bundle.run(batch)
    _assert_equal(served, _live(model, batch))
    jdir = jexport.save_bundle(str(tmp_path / "jax"), TINY, params,
                               _jbatch(batch), platforms=("cpu",))
    jout = jexport.load_bundle(jdir).run(_jbatch(batch))
    for k in OUT_KEYS:
        np.testing.assert_allclose(served[k].numpy(), np.asarray(jout[k]),
                                   atol=JAX_TOL, rtol=0, err_msg=k)
    meta = bundle.meta
    assert meta["device"] == "cpu" and meta["config"]["d_model"] == \
        TINY.d_model
    assert meta["batch_shapes"]["points"] == list(batch.points.shape)
    assert sorted(np.load(os.path.join(out, "params.npz")).files) == \
        sorted(model.state_dict())

    cfg = _torch_config(CONFIGS["packed"])
    packed = OcOccNetWithLoss(cfg, "cpu", torch.Generator().manual_seed(2))
    out = save_bundle(str(tmp_path / "packed"), cfg, packed.state_dict(),
                      batch, device="cpu")
    _assert_equal(load_bundle(out).run(batch), _live(packed.eval(), batch))


def test_one_bundle_serves_a_second_checkpoint(tmp_path):
    cfg = _torch_config(TINY)
    first = OcOccNetWithLoss(cfg, "cpu", torch.Generator().manual_seed(0))
    second = OcOccNetWithLoss(cfg, "cpu", torch.Generator().manual_seed(1))
    batch = _batch(TINY)
    out = save_bundle(str(tmp_path / "b"), cfg, first.state_dict(), batch,
                      device="cpu")
    served = load_bundle(out, params=second.state_dict()).run(batch)
    _assert_equal(served, _live(second.eval(), batch))
    assert not torch.equal(served["shape_latent"],
                           _live(first.eval(), batch)["shape_latent"])


def test_load_bundle_runs_without_the_model_code(tmp_path):
    """A fresh interpreter whose imports of the port's ``models``,
    ``ops`` and ``configs`` raise loads the bundle and serves it."""
    cfg = dataclasses.replace(_torch_config(TINY), roi_point_budget=24)
    model = OcOccNetWithLoss(cfg, "cpu", torch.Generator().manual_seed(0))
    batch = _batch(TINY)
    out = save_bundle(str(tmp_path / "b"), cfg, model.state_dict(), batch,
                      device="cpu")
    torch.save(tuple(batch), tmp_path / "batch.pt")
    ref = _live(model.eval(), batch)
    code = (
        "import sys, torch\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        parts = name.split('.')\n"
        "        if parts[0] == 'objectcentricocccompletion_torch' and \\\n"
        "                len(parts) > 1 and parts[1] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "BLOCKED = {'models', 'ops', 'configs'}\n"
        "sys.meta_path.insert(0, Block())\n"
        "from objectcentricocccompletion_torch.serving import load_bundle\n"
        f"out = load_bundle({out!r}).run(torch.load("
        f"{str(tmp_path / 'batch.pt')!r}))\n"
        "assert not any(m.split('.')[1:2] and m.split('.')[1] in BLOCKED\n"
        "               for m in sys.modules\n"
        "               if m.startswith('objectcentricocccompletion_torch'))\n"
        f"torch.save(out, {str(tmp_path / 'served.pt')!r})\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    _assert_equal(torch.load(tmp_path / "served.pt"), ref)
    # the model code is blocked for real there
    res = subprocess.run(
        [sys.executable, "-c", code.split("from objectcentric")[0]
         + "import objectcentricocccompletion_torch.models.ococcnet\n"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "blocked" in res.stderr
