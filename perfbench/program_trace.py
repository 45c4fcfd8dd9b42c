"""Reading the port's own spans (``repro_torch.core.trace``) against the
device trace of a ``--trace 1`` run.

The port's recorder keeps spans on ``perf_counter_ns`` and maps them
onto the profiler export's clock itself (``Recorder.chrome_events``),
so the spans here are Chrome ``"X"`` events on the trace's ``ts``, with
``args`` holding the span and parent ids, the pthread id, the request
ids (``req``) and the attributes.  A launch is matched to a span by its
thread: the trace names a thread by its native id or, for one that
existed before the profiler started, by the low 32 bits of its pthread
id, unsigned, signed or (torch 2.11 on the H100) negated.

The quantities, each from the window range of the trace:

* ``idle_tokenize``: share of the window with nothing on the device
  while the innermost open span on any thread was ``encoder.tokenize``;
* ``cache_write_ms_per_topic``: ``cache.write`` time over topics;
* ``queue_wait_ms``: median of a request's ``serve.queue``;
* ``worker_wait_ms``: median over requests of their batch's
  ``serve.pool_wait`` summed;
* ``device_queue_ms``: median over requests of ``encoder.sync`` less
  the device time of what that request's ``encoder.call`` launched;
* ``device_wait_ms``: the same with ``encoder.h2d`` and
  ``encoder.replay`` added to ``encoder.sync`` (a call's host may wait
  on the device before its launch too);
* ``idle_with_work``: share of the window with nothing on the device
  while a ``serve.request`` was open;

and the checks of the clock and the coverage: the share of graph
launches inside an ``encoder.call`` of the launching thread, and the
idle time no span names.

The harness does not turn the recorder on yet; :func:`record_cell` runs
a cell through ``harness.run_cell`` with it on for the window alone,
and ``python3 perfbench/program_trace.py`` (the arguments of ``run.py``)
prints the result line with a ``program`` object of these readings.
"""
from __future__ import annotations

import bisect
import importlib
import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

if not __package__:                      # run as a script
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.trace import WINDOW_RANGE, _DEVICE, _LAUNCH, _union  # noqa: E402

__all__ = ["device_busy", "idle_by_innermost", "idle_tokenize",
           "cache_write_ms_per_topic", "queue_wait_ms", "worker_wait_ms",
           "device_queue_ms", "device_wait_ms", "idle_with_work",
           "request_breakdown_ms", "launch_coverage", "read_all",
           "record_cell", "readings"]

#: spans that wait rather than work: a request's envelope and queues
WAITS = ("serve.request", "serve.queue", "serve.pool_wait")
#: an encoder call's children in which the host waits on the device
DEVICE_WAITS = ("encoder.h2d", "encoder.replay", "encoder.sync")
#: spans a recorded window keeps (~5,000 in either cell's 50 s)
CAPACITY = 2_000_000


def _threads(span: Dict) -> Tuple[int, ...]:
    """The ids a launch from this span's thread may carry (see
    ``repro_torch.core.trace.SpanRecord``)."""
    p = span["args"].get("pthread")
    ids = (span["tid"],)
    return ids if p is None else ids + (p, p - (1 << 32), (1 << 32) - p)


def _end(e: Dict) -> float:
    return e["ts"] + e["dur"]


def _median(xs: Sequence[float]) -> Optional[float]:
    return float(statistics.median(xs)) if xs else None


def window_of(events: Sequence[Dict]) -> Tuple[float, float]:
    for e in events:
        if e.get("cat") == "user_annotation" \
                and e.get("name") == WINDOW_RANGE:
            return e["ts"], _end(e)
    raise RuntimeError("the trace holds no window range")


def device_busy(events: Sequence[Dict], w0: float, w1: float
                ) -> List[Tuple[float, float]]:
    """The union of device operations inside the window (µs)."""
    return _union((max(e["ts"], w0), min(_end(e), w1)) for e in events
                  if e.get("cat") in _DEVICE
                  and min(_end(e), w1) > max(e["ts"], w0))


def _idle(busy: List[Tuple[float, float]], w0: float, w1: float
          ) -> List[Tuple[float, float]]:
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def idle_by_innermost(busy: List[Tuple[float, float]],
                      spans: Sequence[Dict], w0: float, w1: float
                      ) -> Dict[str, float]:
    """Device idle time (µs) by the innermost (shortest) span open on
    any thread at each moment, ``""`` where none is."""
    cuts = sorted({x for s in spans for x in (s["ts"], _end(s))})
    starts = sorted(spans, key=lambda s: s["ts"])
    out: Dict[str, float] = defaultdict(float)
    active: List[Dict] = []
    j = 0
    for a, b in _idle(busy, w0, w1):
        inner = cuts[bisect.bisect_right(cuts, a):
                     bisect.bisect_left(cuts, b)]
        for x, y in zip([a] + inner, inner + [b]):
            mid = 0.5 * (x + y)
            while j < len(starts) and starts[j]["ts"] <= mid:
                active.append(starts[j])
                j += 1
            active = [s for s in active if _end(s) >= mid]
            best = min(active, key=lambda s: s["dur"], default=None)
            out[best["name"] if best else ""] += y - x
    return dict(out)


def _intersect(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]
               ) -> List[Tuple[float, float]]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(parts: Iterable[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in parts)


def idle_tokenize(busy, spans, w0, w1) -> float:
    """% of the window idle under ``encoder.tokenize``."""
    return 100.0 * idle_by_innermost(busy, spans, w0, w1).get(
        "encoder.tokenize", 0.0) / (w1 - w0)


def cache_write_ms_per_topic(spans, topics: int) -> Optional[float]:
    if not topics:
        return None
    return sum(s["dur"] for s in spans if s["name"] == "cache.write") \
        / 1e3 / topics


def _requests(spans) -> List[int]:
    return [r for s in spans if s["name"] == "serve.request"
            for r in s["args"]["req"]]


def queue_wait_ms(spans) -> Optional[float]:
    done = set(_requests(spans))
    return _median([s["dur"] / 1e3 for s in spans
                    if s["name"] == "serve.queue"
                    and s["args"]["req"][0] in done])


def worker_wait_ms(spans) -> Optional[float]:
    wait: Dict[int, float] = defaultdict(float)
    for s in spans:
        if s["name"] == "serve.pool_wait":
            for r in s["args"]["req"]:
                wait[r] += s["dur"] / 1e3
    return _median([wait[r] for r in _requests(spans)])


def _launches(events) -> Dict[Any, Tuple[float, Any, str]]:
    """correlation -> (ts, thread, name) of each launch."""
    out = {}
    for e in events:
        if e.get("cat") in _LAUNCH:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                out[corr] = (e["ts"], e.get("tid"), e.get("name", ""))
    return out


class _CallIndex:
    """The ``encoder.call`` spans of each thread, to find the one a
    launch came from."""

    def __init__(self, spans):
        self.by_thread: Dict[Any, List[Tuple[float, float, Dict]]] = \
            defaultdict(list)
        for s in spans:
            if s["name"] == "encoder.call":
                for t in _threads(s):
                    self.by_thread[t].append((s["ts"], _end(s), s))
        for v in self.by_thread.values():
            v.sort(key=lambda x: x[0])
        self.starts = {t: [x[0] for x in v]
                       for t, v in self.by_thread.items()}

    def find(self, tid, ts: float) -> Optional[Dict]:
        v = self.by_thread.get(tid)
        if not v:
            return None
        i = bisect.bisect_right(self.starts[tid], ts) - 1
        if i >= 0 and v[i][1] >= ts:
            return v[i][2]
        return None


def _own_device_us(events, spans) -> Dict[int, float]:
    """``encoder.call`` span id -> µs of the device operations launched
    from inside it (matched by correlation id and thread)."""
    idx = _CallIndex(spans)
    launch = _launches(events)
    dev: Dict[int, float] = defaultdict(float)
    for e in events:
        if e.get("cat") not in _DEVICE:
            continue
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is None:
            continue
        call = idx.find(src[1], src[0])
        if call is not None:
            dev[call["args"]["id"]] += e["dur"]
    return dev


def _beyond_own_device_ms(events, spans, children: Sequence[str]
                          ) -> Optional[float]:
    """Median over the served requests of the time their encoder calls
    spent in ``children`` less the device time those calls launched."""
    dev = _own_device_us(events, spans)
    held: Dict[int, float] = defaultdict(float)     # call id -> µs
    for s in spans:
        if s["name"] in children:
            held[s["args"]["parent"]] += s["dur"]
    per_req: Dict[int, float] = defaultdict(float)
    for s in spans:
        if s["name"] == "encoder.call" and s["args"]["id"] in held:
            q = held[s["args"]["id"]] - dev.get(s["args"]["id"], 0.0)
            for r in s["args"].get("req", ()):
                per_req[r] += q / 1e3
    return _median([per_req[r] for r in _requests(spans) if r in per_req])


def device_queue_ms(events, spans) -> Optional[float]:
    """``encoder.sync`` beyond the call's own device time: the stream's
    queue after the launch."""
    return _beyond_own_device_ms(events, spans, ("encoder.sync",))


def device_wait_ms(events, spans) -> Optional[float]:
    """``encoder.h2d`` + ``encoder.replay`` + ``encoder.sync`` beyond
    the call's own device time: every wait of the host on the device
    within a call, before its launch included."""
    return _beyond_own_device_ms(events, spans, DEVICE_WAITS)


def _open(spans, name: str) -> List[Tuple[float, float]]:
    return _union((s["ts"], _end(s)) for s in spans if s["name"] == name)


def idle_with_work(busy, spans, w0, w1) -> float:
    """% of the window idle while a ``serve.request`` was open."""
    held = _intersect(_idle(busy, w0, w1), _open(spans, "serve.request"))
    return 100.0 * _length(held) / (w1 - w0)


def request_breakdown_ms(spans) -> Dict[str, float]:
    """Median over the served requests of the milliseconds each span
    name took on their behalf (a span of a micro-batch counts for each
    of its requests); ``serve.request`` is the whole of it."""
    per: Dict[Any, Dict[str, float]] = defaultdict(lambda: defaultdict(
        float))
    for s in spans:
        for r in s["args"].get("req", ()):
            per[r][s["name"]] += s["dur"] / 1e3
    done = _requests(spans)
    names = sorted({n for r in done for n in per[r]})
    return {n: _median([per[r].get(n, 0.0) for r in done]) for n in names}


def launch_coverage(events, spans, name: str = "cudaGraphLaunch"
                    ) -> Tuple[int, int]:
    """(launches named ``name`` in the window inside an ``encoder.call``
    of the launching thread, all such launches)."""
    w0, w1 = window_of(events)
    idx = _CallIndex(spans)
    hit = total = 0
    for ts, tid, n in _launches(events).values():
        if n == name and w0 <= ts <= w1:
            total += 1
            hit += idx.find(tid, ts) is not None
    return hit, total


def read_all(events: Sequence[Dict], spans: Sequence[Dict],
             topics: int = 0) -> Dict[str, Any]:
    """Every reading of one traced window: the quantities above, the
    launch coverage, and the device's idle time by innermost span."""
    w0, w1 = window_of(events)
    busy = device_busy(events, w0, w1)
    idle = _idle(busy, w0, w1)
    names = {s["name"] for s in spans}
    out: Dict[str, Any] = {"window_s": (w1 - w0) * 1e-6,
                           "idle_s": _length(idle) * 1e-6}
    by = idle_by_innermost(busy, spans, w0, w1)
    out["idle_by_span_s"] = {k or "none": v * 1e-6 for k, v in
                             sorted(by.items(), key=lambda kv: -kv[1])}
    out["idle_no_span_share"] = \
        by.get("", 0.0) / _length(idle) if idle else None
    if "encoder.tokenize" in names:
        out["idle_tokenize"] = \
            100.0 * by.get("encoder.tokenize", 0.0) / (w1 - w0)
    if "cache.write" in names:
        out["cache_write_ms_per_topic"] = cache_write_ms_per_topic(
            spans, topics)
    if "serve.request" in names:
        out["queue_wait_ms"] = queue_wait_ms(spans)
        out["worker_wait_ms"] = worker_wait_ms(spans)
        out["device_queue_ms"] = device_queue_ms(events, spans)
        out["device_wait_ms"] = device_wait_ms(events, spans)
        held = _intersect(idle, _open(spans, "serve.request"))
        out["idle_with_work"] = 100.0 * _length(held) / (w1 - w0)
        # of that idle time, the share in which no span but the
        # requests' own was open on any thread, and the share in which
        # none but a wait (a request, its queues) was
        for key, skip in (("unnamed", ("serve.request",)),
                          ("waiting", WAITS)):
            named = _union((s["ts"], _end(s)) for s in spans
                           if s["name"] not in skip)
            out[f"idle_with_work_{key}_share"] = (
                1.0 - _length(_intersect(held, named)) / _length(held)
                if held else None)
    hit, total = launch_coverage(events, spans)
    out["graph_launches"] = total
    out["graph_launches_in_encoder_call"] = hit
    return out


def record_cell(cell, **run_kw) -> Dict:
    """One run of ``cell`` through ``harness.run_cell`` (``run_kw``: its
    keywords) with the port's recorder on for the window alone.
    Returns the result line, the recorder, the probe, and the exported
    trace's events (traced runs on the card)."""
    from perfbench import harness
    from repro_torch.core import trace as port_trace
    # replaces ``driver.window`` and ``harness.summarize`` for the run,
    # so it needs ``run_cell`` to look both up by module attribute
    # (``test_perfbench_program_trace.py`` holds it to that)
    driver = importlib.import_module(
        f"perfbench.traffic.{cell.traffic['driver']}")
    window, summarize = driver.window, harness.summarize
    got: Dict[str, Any] = {}

    def recorded(run, state, seconds):
        got["probe"] = run.probe
        port_trace.enable(CAPACITY)
        try:
            return window(run, state, seconds)
        finally:
            got["recorder"] = port_trace.disable()

    def keep(path, *args, **kwargs):
        with open(path) as f:
            got["trace"] = json.load(f)
        return summarize(path, *args, **kwargs)

    driver.window, harness.summarize = recorded, keep
    try:
        got["result"] = harness.run_cell(cell, **run_kw)
    finally:
        driver.window, harness.summarize = window, summarize
    return got


def readings(got: Dict) -> Dict[str, Any]:
    """The ``program`` object of a recorded run: counters, drops, the
    clock pairs' drift and, with a device trace, :func:`read_all`."""
    rec = got["recorder"]
    out: Dict[str, Any] = {
        "spans": len(rec.spans), "dropped": rec.dropped,
        "drift_us": rec.drift_ns() / 1e3,
        "counters": dict(rec.counters)}
    tr = got.get("trace")
    spans = rec.chrome_events(int(tr["baseTimeNanoseconds"]) if tr else 0)
    if any(s["name"] == "serve.request" for s in spans):
        out["request_ms"] = request_breakdown_ms(spans)
    if tr is not None:
        topics = got["result"]["counters"].get("topics", 0)
        out.update(read_all(tr["traceEvents"], spans, topics))
    return out


def main(argv=None) -> int:
    import argparse
    import time
    t_start = time.perf_counter()
    from perfbench import run as bench
    bench._environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    a = ap.parse_args(argv)
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("program_trace: no CUDA device", file=sys.stderr)
        return 2
    got = record_cell(harness.load_cell(a.workload), seed=a.seed,
                      seconds=a.seconds, trace=bool(a.trace),
                      device="cuda", t_start=t_start)
    out = dict(got["result"])
    out["program"] = readings(got)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
