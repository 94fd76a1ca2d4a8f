"""The port's ``utils/profiling.py`` on the CPU: ``trace`` writes a Chrome
trace, ``annotate`` names a span in it, ``StepTimer`` reports its mean."""
import json
import os

import torch

from objectcentricocccompletion_torch.utils.profiling import (StepTimer,
                                                              annotate,
                                                              trace)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def test_trace_annotate_and_step_timer(tmp_path, capsys):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "trace")) as prof:
        with annotate("ococc_span"):
            y = (x @ x).relu().sum()
    assert prof is not None and float(y) > 0
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "ococc_span"]
    assert spans and spans[0]["dur"] > 0
    assert any(e.get("name") == "aten::mm" for e in events)
    assert os.path.getsize(path) > 0

    timer = StepTimer("unit", report_every=2)
    for _ in range(4):
        timer.start()
        (x @ x).sum()
        timer.stop(sync_on=x)
    timer.start()
    timer.stop(sync_on="cpu")
    out = capsys.readouterr().out.splitlines()
    reports = [line for line in out if line.startswith("[unit] avg ")]
    assert len(reports) == 2, out
    assert all(line.endswith("ms over last 2 steps") for line in reports)
