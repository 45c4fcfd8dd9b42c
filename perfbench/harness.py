"""One run of one cell: set-up, the measured window, the metrics, the
judgement and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* ``perfbench/configs/<config>.json``: the model and corpus sizes (the
  ``file`` of the configuration's entry);
* ``perfbench/workloads/<traffic>.json``: the traffic mix, which names
  its driver (a module of ``perfbench/traffic``) and its parameters;
* ``perfbench/limits/<cell>.json``: the limit of each number the judge
  compares in this cell;
* ``perfbench/metrics/<metric>.py``: one reader per metric, ``read(m)``
  returning the metric's value or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from .trace import WINDOW_RANGE, summarize

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(name: str, spec: Optional[Dict] = None) -> Cell:
    if spec is None:
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (PACKAGE / "workloads" / f"{w['traffic']}.json").read_text())
    limits = json.loads((PACKAGE / "limits" / f"{name}.json").read_text())

    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name, config, traffic, limits, e2e, layer)


def reader(metric: str):
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics._read_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    probe: Any = None

    @property
    def config(self) -> Dict:
        return self.cell.config

    @property
    def traffic(self) -> Dict:
        return self.cell.traffic

    @property
    def limits(self) -> Dict[str, float]:
        return self.cell.limits


@dataclass
class Measured:
    """What the metric readers read."""
    config: Dict
    setup_s: float
    window_s: float
    record: Dict
    counters: Dict[str, float]
    spans: Any = None                 # program.Spans, traced runs only
    device: Optional[Dict] = None     # trace.summarize, traced runs only


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: str, t_start: float,
             control: Optional[str] = None) -> Dict:
    """One run; returns the result line's object."""
    from . import program

    tf32 = control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    driver = importlib.import_module(
        f"perfbench.traffic.{cell.traffic['driver']}")
    run = Run(cell, seed, seconds, trace, device)
    cuda = device.startswith("cuda")
    program.use_device(device)
    with program.Probe(cell.config, trace) as probe:
        run.probe = probe
        state = driver.setup(run)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        probe.recording = True
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        try:
            with torch.profiler.record_function(WINDOW_RANGE):
                anchor = time.perf_counter()
                rec = driver.window(run, state, seconds)
                if cuda:
                    torch.cuda.synchronize()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        probe.recording = False
        summary = None
        if prof is not None and cuda:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                summary = summarize(path, probe.spans.intervals, anchor,
                                    program.ENCODER_RANGE)
                print("trace: launches from threads no span names: "
                      f"{summary['launch_threads_unmatched']}; span threads: "
                      f"{sorted({t for _, ts, _, _ in probe.spans.intervals for t in ts})}",
                      file=sys.stderr)
            finally:
                os.unlink(path)
        del prof
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        driver.close(state)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        m = Measured(cell.config, setup_s, rec["window_s"], rec,
                     rec["counters"], probe.spans if trace else None,
                     summary)
        numbers = driver.judge(run, state, rec)

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for spec in wanted:
        v = reader(spec["name"])(m)
        if v is not None:
            metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}

    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and rec["failed"] == 0
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["counters"] = rec["counters"]
    out["checks"] = checks
    return out
