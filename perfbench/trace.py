"""Reading the device trace of a ``--trace 1`` run.

``torch.profiler`` records the window with CPU and CUDA activities and
exports a Chrome trace.  The host side comes from the benchmark's own
spans (``program.Spans.intervals``: name, thread ids, start and end on
``time.perf_counter``), placed on the trace's clock through the
``window`` range, opened at the window's start: the profiler records no
range of a thread that existed before it started, such as a service's
workers, but it records every launch, with its thread (the native id,
or for such a thread the low 32 bits of its pthread id, which may read
as a signed number).  From the trace:

* ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device, inside the window;
* ``window_s``: the length of the ``window`` range;
* ``encoder_device_s``: the device time of the operations launched
  (matched through the launch's correlation id and thread) while that
  thread was inside an encoder call, CUDA-graph replays included; a
  launch from a thread the spans cannot name counts where it falls
  inside any thread's encoder call;
* ``device_ops``: the ten operations that took most device time, summed
  by name;
* ``idle_gaps``: the device's idle time inside the window, summed by the
  innermost span the host was in at the middle of each gap (``host``
  where it was in none), the ten largest.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

__all__ = ["summarize", "WINDOW_RANGE"]

WINDOW_RANGE = "window"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _inside(ranges: List[Tuple[float, float]], t: float) -> bool:
    """Whether ``t`` lies in one of ``ranges`` (sorted, disjoint)."""
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][1] >= t


def summarize(path: str, spans: Sequence[Tuple[str, Tuple[int, ...],
                                               float, float]],
              anchor: float, encoder_span: str) -> Dict:
    """``spans``: (name, thread ids, start, end) in seconds of the clock
    on which the window started at ``anchor``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, launch, w0, w1 = [], {}, None, None
    for e in events:
        cat = e.get("cat")
        if cat in _DEVICE:
            device.append(e)
        elif cat in _LAUNCH:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["ts"], e.get("tid"))
        elif cat == "user_annotation" and e.get("name") == WINDOW_RANGE:
            w0, w1 = e["ts"], e["ts"] + e["dur"]
    if w0 is None:
        raise RuntimeError("the trace holds no window range")
    host = sorted(((w0 + (a - anchor) * 1e6, w0 + (b - anchor) * 1e6,
                    name, tids) for name, tids, a, b in spans),
                  key=lambda h: (h[0], -h[1]))
    enc: Dict = defaultdict(list)
    for a, b, name, tids in host:
        if name == encoder_span:
            for tid in tids:
                enc[tid].append((a, b))
            enc[None].append((a, b))
    enc[None] = _union(enc[None])

    busy_parts, by_name, enc_s, unmatched = [], defaultdict(float), 0.0, set()
    for e in device:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        busy_parts.append((a, b))
        by_name[e.get("name", "?")[:160]] += (b - a) * 1e-6
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is not None:
            ts, tid = src
            if tid not in enc:
                unmatched.add(tid)
            if _inside(enc[tid] if tid in enc else enc[None], ts):
                enc_s += (b - a) * 1e-6
    busy = _union(busy_parts)

    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    active: List = []
    j = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        inner = min(active, key=lambda h: h[1] - h[0], default=None)
        gaps[inner[2] if inner else "host"] += (b - a) * 1e-6

    def top(d):
        return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6, "encoder_device_s": enc_s,
            "launch_threads_unmatched": sorted(unmatched),
            "device_ops": top(by_name), "idle_gaps": top(gaps)}
