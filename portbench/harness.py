"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix's ``mode`` names the
module that runs it (``modes/<mode>.py``) and the configuration's
``reference`` its plain reference (``reference/<name>.py``). The limits of
the numbers that decide ``correct`` are in ``limits/<cell>.json``, and each
per-layer metric is read by ``metrics/<metric>.py`` (or
``metrics/<prefix>.py``, the part of its name before the first dot).
Nothing here names a cell.

A new configuration, mix or cell comes in new files alone, each found by
the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run, with its
  ``name``, ``reference``, ``reduced`` and ``precision``;
- ``traffic/<mix>.json``: the mix's parameters and its ``mode``;
- ``modes/<mode>.py`` (a new mode only): ``Mode``, the timed path and its
  check, and beside it ``FAULTS`` (the faults its timed path can have),
  ``TINY_MIX`` (the overrides that cut its mix to the CPU tests' size),
  ``CARD_SECONDS`` (the card test's short window) and, for a mode whose
  strongest fault short of the control is run on the card, ``HALF_FAULT``;
- ``reference/<config>.py``: the plain reference, one per configuration,
  importing neither the port nor the rest of the benchmark;
- ``counts_<config>.py`` beside ``counts.py``: the configuration's
  operation counts, so that ``counts.py`` is never edited to add a model;
- ``tests/tiny_<config>.py``: ``config()``, the configuration at the CPU
  tests' size;
- ``tests/test_portbench_config_<config>.py``: the file held to its
  source;
- ``limits/<cell>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: a new per-layer metric's reader (``SOURCE``
  names the span or the ``(useful, slots)`` counters a reader of the
  program's tracer takes).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the harness's own spans around each call into the port
SPANS = ("h2d", "predict", "decode_occ", "d2h", "train_step")
# top-level names whose presence after the window fails a run
FORBIDDEN = ("jax", "jaxlib", "flax", "objectcentricocccompletion_tpu")
TOP_N = 10


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration,
    mix, limits and the per-layer metrics it reports."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", cells)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", cells if m["moves"] in moved
                              else ())]
    return dict(cell=cell, config=load_json(ROOT / config["file"]),
                mix=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def mode_module(mix: dict):
    return importlib.import_module(f"portbench.modes.{mix['mode']}")


def reader_module(metric: str):
    """The module that reads a per-layer metric: ``metrics/<name>.py``,
    else ``metrics/<prefix>.py``."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"portbench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for {metric} under {HERE / 'metrics'}")


def reader(metric: str):
    """The reader of a per-layer metric: ``reader_module(metric).read``."""
    return reader_module(metric).read


def set_precision(config: dict) -> None:
    """The precision settings the configuration states (TF32 off for
    float32 matrix products and convolutions)."""
    import torch
    prec = config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = prec["matmul_allow_tf32"]
    torch.backends.cudnn.allow_tf32 = prec["cudnn_allow_tf32"]


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------ traces

def merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(prof, span: str = "traced") -> SimpleNamespace:
    """The traced stretch from a ``torch.profiler`` run: device events
    (kernels, copies, sets) inside the span ``span``, the union of their
    intervals, the longest device operations and the idle gaps by what the
    host was doing. Times in seconds."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    win = [e for e in events if e.name == span]
    if not win:
        raise RuntimeError(f"the trace holds no span {span!r}")
    t0, t1 = win[0].time_range.start, win[0].time_range.end
    # device work only: the spans' copies on the device timeline
    # (user annotations) are no work
    dev = [(max(e.time_range.start, t0), min(e.time_range.end, t1), e.name)
           for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name not in SPANS and e.name != span
           and e.time_range.end > t0 and e.time_range.start < t1]
    busy = merge([[s, e] for s, e, _ in dev if e > s])
    busy_us = sum(e - s for s, e in busy)
    ops: dict = {}
    for s, e, n in dev:
        ops[n] = ops.get(n, 0.0) + (e - s)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    cpu = sorted(((e.time_range.start, e.time_range.end, e.name, e.thread)
                  for e in events if e.device_type == DeviceType.CPU
                  and e.name != span), key=lambda r: (r[0], -r[1]))
    idle = _label_gaps(gaps, cpu)
    return SimpleNamespace(
        window_s=(t1 - t0) * 1e-6, busy_s=busy_us * 1e-6,
        device_events=dev,
        device_ops=[[n, t * 1e-6] for n, t in sorted(
            ops.items(), key=lambda kv: -kv[1])[:TOP_N]],
        idle_gaps=[[n, t * 1e-6] for n, t in sorted(
            idle.items(), key=lambda kv: -kv[1])[:TOP_N]])


def _label_gaps(gaps: list, cpu: list) -> dict:
    """Idle seconds (in trace microseconds) by what the host was doing at
    each gap's midpoint: the harness span and the innermost host operation
    open then."""
    out: dict = {}
    stacks: dict = {}
    i = 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        while i < len(cpu) and cpu[i][0] <= mid:
            s, e, n, th = cpu[i]
            st = stacks.setdefault(th, [])
            while st and st[-1][1] < s:
                st.pop()
            st.append((s, e, n))
            i += 1
        open_ = []
        for st in stacks.values():
            while st and st[-1][1] < mid:
                st.pop()
            open_ += [r for r in st if r[1] >= mid]
        span = next((r[2] for r in sorted(open_, key=lambda r: r[0])
                     if r[2] in SPANS), "between calls")
        inner = max(open_, key=lambda r: r[0])[2] if open_ else "idle host"
        label = span if inner == span else f"{span}: {inner}"
        out[label[:160]] = out.get(label[:160], 0.0) + (g1 - g0)
    return out


# --------------------------------------------------------------------- run

def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, dtype: str | None = None, fault=None) -> dict:
    """One run of the cell ``spec`` (``load_cell``) on ``device``: returns
    the result object. ``dtype`` runs the port at another compute dtype
    (the control); ``fault`` breaks the timed path (the tests' faults)."""
    import torch
    dev = torch.device(device)
    set_precision(spec["config"])
    phases = [("imports", time.perf_counter())]
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        phases.append(("CUDA context", time.perf_counter()))
    mode = mode_module(spec["mix"]).Mode(spec["config"], spec["mix"], seed,
                                         dev, dtype=dtype, fault=fault)
    phases.append(("program and traffic", time.perf_counter()))
    mode.warm_up()
    sync(dev)
    phases.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("set-up: " + ", ".join(f"{n} {t - prev:.3f} s" for (n, t), prev in
                                 zip(phases, [t_start] + [t for _, t in
                                                          phases[:-1]])),
          file=sys.stderr)

    t0 = time.perf_counter()
    n = 0
    while True:
        mode.call()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    mode.finish()
    sync(dev)
    window_s = time.perf_counter() - t0

    result = dict(correct=False, attempted=n, failed=0, metrics={},
                  device=dict(platform="gpu" if dev.type == "cuda" else "cpu",
                              kind=(torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu"),
                              count=1))
    e2e = mode.end_to_end(window_s)
    e2e["setup_s"] = setup_s
    tr = None
    if trace:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        k = spec["mix"]["trace_calls"]
        mode.start_trace()
        with profile(activities=acts) as prof:
            with record_function("traced"):
                for _ in range(k):
                    mode.call()
                mode.finish()
                sync(dev)
        tr = reduce_trace(prof)
        ctx = SimpleNamespace(
            calls=k, window_s=tr.window_s, busy_s=tr.busy_s,
            device_events=tr.device_events,
            flops_per_s=mode.flops_done / window_s,
            wall_per_call=window_s / n,
            extra=mode.trace_extra(), device=dev)
        for m in spec["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = dict(value=v, unit=m["unit"])
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = dict(device_ops=tr.device_ops,
                                   idle_gaps=tr.idle_gaps)
    else:
        for m in spec["end_to_end"]:
            result["metrics"][m["name"]] = dict(value=e2e[m["name"]],
                                                unit=m["unit"])
    if dev.type == "cuda":
        result["device"]["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(dev))

    # a mode that follows the window's end state takes it now, with the
    # peak read
    if hasattr(mode, "after_window"):
        mode.after_window()
    mode.free_program()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        readings = mode.check()
        for k in sorted(set(readings) - set(spec["limits"])):
            print(f"reading {k}: {readings[k]!r} (not compared)",
                  file=sys.stderr)
        result["correct"] = all(
            math.isfinite(readings[k]) and readings[k] <= lim
            for k, lim in spec["limits"].items())
    except Exception:  # a reference or comparison that fails is a failed check
        traceback.print_exc()
        readings = {}
    # every reading, compared or not; main() leaves it out of the line
    result["readings"] = readings
    result["checks"] = {k: dict(value=readings.get(k, float("nan")),
                                limit=lim)
                        for k, lim in spec["limits"].items()}
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(args, t_start: float) -> int:
    spec = load_cell(args.workload)
    import torch
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # one process with few threads: the work is on the card, and the
    # host's threads would only contend with the port's dispatch
    torch.set_num_threads(1)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t_start)
    result.pop("readings")
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
