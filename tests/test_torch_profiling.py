"""The port's ``utils/profiling.py`` on the CPU: ``trace`` writes a Chrome
trace with the program's spans in it; ``span`` and ``count`` record only
while a profiler session records, nest, carry a call id and start afresh
with each session; the program's spans and counters at the tiny sizes of
OcOccNet's predict and decode, its training step and SST's predict."""
import dataclasses
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from objectcentricocccompletion_torch.configs.ococcnet_config import \
    tiny_config
from objectcentricocccompletion_torch.data.synthetic import (synth_frame,
                                                             synthetic_batch)
from objectcentricocccompletion_torch.models.ococcnet import \
    OcOccNetWithLoss
from objectcentricocccompletion_torch.models.sst_detector import (
    SSTDetector, tiny_sst_detector_config)
from objectcentricocccompletion_torch.ops import voxelize as vx
from objectcentricocccompletion_torch.ops import window as win
from objectcentricocccompletion_torch.parallel.train import (
    create_train_state, make_train_step)
from objectcentricocccompletion_torch.utils import profiling
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

CPU = [ProfilerActivity.CPU]


def test_trace_annotate_and_step_timer(tmp_path):
    """``trace`` writes the Chrome trace, the program's spans in it beside
    the operators (``span`` took ``annotate``'s place; the trainers time
    their own steps)."""
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("ococc_span"):
            y = (x @ x).relu().sum()
    assert prof is not None and float(y) > 0
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "ococc_span"]
    assert spans and spans[0]["dur"] > 0
    assert any(e.get("name") == "aten::mm" for e in events)
    assert os.path.getsize(path) > 0
    assert profiling.snapshot()["spans"]["ococc_span"]["instances"] == 1


def test_off_is_a_shared_null_context():
    with profile(activities=CPU):
        with profiling.span("a"):
            profiling.count("n", 1)
    before = profiling.snapshot()
    assert profiling.span("a") is profiling.span("b") is profiling._NULL
    with profiling.span("a"):
        profiling.count("n", 5)
        profiling.count("m", torch.ones(3))
    assert profiling.snapshot() == before
    assert before["counters"] == {"n": 1}


def test_spans_nest_with_parent_and_call_id():
    x = torch.randn(32, 32)
    with profile(activities=CPU) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                x @ x
            with profiling.span("inner"):
                x + x
        with profiling.span("outer"):
            pass
    ev = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events() if e.name in ("outer", "inner"))
    assert [n for _, _, n in ev] == ["outer", "inner", "inner", "outer"]
    assert all(ev[0][0] <= s and e <= ev[0][1] for s, e, _ in ev[1:3])
    snap = profiling.snapshot()
    rows = [(r["name"], r["parent"], r["call"]) for r in snap["records"]]
    assert rows == [("outer", None, 1), ("inner", 0, 1), ("inner", 0, 1),
                    ("outer", None, 2)]
    for r in snap["records"]:
        assert r["end_ms"] >= r["start_ms"] >= 0
    outer = snap["spans"]["outer"]
    assert outer["instances"] == 2
    # the inner spans' time is the outer's less its self time
    inner = snap["spans"]["inner"]["stream_ms"]
    assert outer["self_ms"] == pytest.approx(outer["stream_ms"] - inner,
                                             abs=1e-9)
    assert outer["stream_ms"] == pytest.approx(outer["host_ms"], rel=0.5)

    # a second session starts afresh
    with profile(activities=CPU):
        with profiling.span("second"):
            pass
    snap = profiling.snapshot()
    assert list(snap["spans"]) == ["second"]
    assert [r["call"] for r in snap["records"]] == [1]


def test_counters_sum_when_read():
    t = torch.zeros(4, dtype=torch.bool)
    name = "test.launches"
    with profile(activities=CPU):
        profiling.count("kept", t)
        profiling.count("slots", t.numel())
        profiling.tally(name, 32)
        profiling.tally(name, 144)
    profiling.tally(name, 32)
    t[:3] = True                      # the tensor is summed only now
    try:
        assert profiling.snapshot()["counters"] == {"kept": 3, "slots": 4,
                                                    name: 2}
        assert profiling.TALLIES[name] == {32: 2, 144: 1}
    finally:
        del profiling.TALLIES[name]


def _refine():
    cfg = dataclasses.replace(tiny_config(), packed_point_budget=128,
                              packed_quantum=16)
    model = OcOccNetWithLoss(cfg, "cpu", torch.Generator().manual_seed(0))
    model.eval()
    batch = synthetic_batch(cfg, seed=0)
    queries = batch.occ_points[:, None].expand(
        -1, cfg.reg_len, -1, -1).contiguous()

    def call():
        with torch.no_grad():
            out = model.predict(batch)
            model.decode_occ_queries(out["shape_latent"], queries)
        return out

    out = call()
    packed = model.net.point_layout(batch).packed
    B, L = out["nonempty"].shape
    want = {"ococcnet.points_kept": int(packed.valid.sum()),
            "ococcnet.point_slots": packed.valid.numel(),
            "ococcnet.frames_nonempty": int(out["nonempty"].sum()),
            "ococcnet.frame_slots": B * L}
    assert want["ococcnet.points_kept"] < B * L * cfg.max_points_per_frame
    roots = {"ococcnet.predict": None, "ococcnet.layout": "ococcnet.predict",
             "ococcnet.encode": "ococcnet.predict",
             "ococcnet.temporal": "ococcnet.predict",
             "ococcnet.occ_decoder": None}
    return call, roots, want


def _train():
    cfg = tiny_config()
    model, opt, schedule = create_train_state(cfg, 10, "cpu")
    step_fn = make_train_step(model, opt, schedule)
    batch = synthetic_batch(cfg, seed=1)
    B, L = batch.rois.shape[:2]
    steps = iter(range(10))
    roots = {"train.step": None, "train.h2d": "train.step",
             "train.forward": "train.step", "train.backward": "train.step",
             "train.optimizer": "train.step",
             "ococcnet.layout": "train.forward",
             "ococcnet.encode": "train.forward",
             "ococcnet.temporal": "train.forward",
             "ococcnet.occ_decoder": "train.forward"}
    kept = model.net.point_layout(batch).kept()         # the dense layout
    want = {"ococcnet.points_kept": int(kept.sum()),
            "ococcnet.point_slots": kept.numel(),
            "ococcnet.frames_nonempty": int(kept.any(-1).sum()),
            "ococcnet.frame_slots": B * L}
    return (lambda: step_fn(next(steps), batch)), roots, want


def _detect():
    cfg = tiny_sst_detector_config()
    s = cfg.sst
    model = SSTDetector(cfg, "cpu", torch.Generator().manual_seed(0))
    model.eval()
    pts, msk = (torch.from_numpy(a) for a in synth_frame(
        s.max_points, s.pc_range, num_real=1500, seed=3)[:2])

    def call():
        with torch.no_grad():
            return model.predict(pts, msk, 50)

    # the token masks of the blocks, laid out again, and the voxel rows
    vres = vx.voxelize(pts, msk, s.voxel_size, s.pc_range, s.max_voxels)
    shifts = model.backbone.partitions(vres)
    x = torch.zeros(s.max_voxels, 1)
    tokens = slots = rows = row_slots = 0
    for i in range(len(model.backbone.layers)):
        for lv in shifts[i % 2].levels:
            mw, cap = lv.mask.shape
            tokens += int(win.flat_to_window(x, lv.part, mw, cap)[1].sum())
            slots += mw * cap
        rows += int(vres.voxel_valid.sum())
        row_slots += s.max_voxels
    assert 0 < tokens < slots and 0 < rows <= row_slots
    roots = {"sst.predict": None, "sst.voxelize": "sst.predict",
             "sst.blocks": "sst.predict", "sst.neck": "sst.predict",
             "sst.head": "sst.predict"}
    return call, roots, {"sst.tokens": tokens, "sst.token_slots": slots,
                         "sst.rows": rows, "sst.row_slots": row_slots}


@pytest.mark.parametrize("path", [_refine, _train, _detect],
                         ids=["refine", "train", "detect"])
def test_program_spans_once_per_call(path):
    """Each span of the path once per call, under its parent, the spans of
    a call sharing its id; the counters per call."""
    call, roots, want = path()
    call()                               # outside any session: nothing
    calls = 2
    with profile(activities=CPU):
        for _ in range(calls):
            call()
    snap = profiling.snapshot()
    assert {k: v["instances"] for k, v in snap["spans"].items()} == \
        {k: calls for k in roots}
    rows = snap["records"]
    for r in rows:
        parent = rows[r["parent"]] if r["parent"] is not None else None
        assert (parent and parent["name"]) == roots[r["name"]]
        assert parent is None or parent["call"] == r["call"]
    assert snap["counters"] == {k: calls * v for k, v in want.items()}
