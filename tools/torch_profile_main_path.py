#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one GPU.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/torch_profile_main_path.py

Sets up the main path of ``chip_smoke.py`` (the Table 2 retrieve-and-
rerank Experiment with BM25 and dense retrieval over
``msmarco_like(2, scale=1.0)``), runs it once to warm up, then:

1. once plain: host wall time per system;
2. once under ``torch.profiler``: device time by kernel name and the
   device's busy share of the plain run's wall time;
3. once under ``cProfile``: the host functions with the most
   cumulative time;
4. ``dense_topk`` alone on random inputs at the main shape and around
   it (query rows, width, k, corpus size), CUDA events as in
   ``chip_smoke.py``.

Prints one line per finding and a JSON summary last.  Exits 1 without
a CUDA device.
"""
from __future__ import annotations

import cProfile
import io
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    import torch
    if not chip_smoke.start(torch):
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    mp = chip_smoke.setup_main_path(torch)
    mp.run("cuda")                                  # warm-up

    t = time.perf_counter()
    res = mp.run("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"plain: wall {wall:.3f} s; per system "
          f"{json.dumps({n: round(s, 3) for n, s in res.times_s.items()})}",
          flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mp.run("cuda")
        torch.cuda.synchronize()
    # device-side events only: the operators' own rows repeat the time
    # of the kernels they launch
    kernels = sorted(((e.key, _device_us(e), e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and _device_us(e) > 0),
                     key=lambda x: -x[1])
    topk_us = sum(us for name, us, _ in kernels if "dense_topk" in name)
    device_s = sum(us for _, us, _ in kernels) / 1e6
    print(f"profiler: device busy {device_s:.4f} s of the plain run's "
          f"{wall:.3f} s wall ({100 * device_s / wall:.2f} %)", flush=True)
    print(f"profiler: dense_topk kernels {topk_us / 1e3:.3f} ms in all",
          flush=True)
    for name, us, count in kernels[:12]:
        print(f"profiler: {us / 1e3:10.3f} ms {count:7d}x {name[:90]}",
              flush=True)

    pr = cProfile.Profile()
    pr.enable()
    mp.run("cuda")
    torch.cuda.synchronize()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(25)
    host = [line for line in buf.getvalue().splitlines()
            if line.strip() and line.strip()[0].isdigit()]
    for line in host:
        print(f"cprofile: {line}", flush=True)

    # the kernel alone at the main shape and around it: query rows (one
    # block each), width d (the dot products) and k (the merge)
    from repro_torch.kernels.dense_topk import dense_topk
    gen = torch.Generator().manual_seed(0)
    sweep = {}
    for Q, N, d, k in [(1, 39600, 128, 200), (53, 39600, 128, 200),
                       (132, 39600, 128, 200), (264, 39600, 128, 200),
                       (53, 39600, 32, 200), (53, 39600, 512, 200),
                       (53, 39600, 128, 10), (53, 39600, 128, 1000),
                       (53, 9900, 128, 200)]:
        q = torch.randn(Q, d, generator=gen).cuda()
        c = torch.randn(N, d, generator=gen).cuda()
        ms = chip_smoke.time_ms(torch, lambda: dense_topk(q, c, k=k))
        sweep[f"Q={Q} N={N} d={d} k={k}"] = ms
        print(f"sweep: dense_topk Q={Q} N={N} d={d} k={k}: {ms:.4f} ms",
              flush=True)

    print(json.dumps({"card": card, "wall_s": wall, "device_busy_s": device_s,
                      "device_busy_share": device_s / wall,
                      "dense_topk_ms": topk_us / 1e3,
                      "top_kernels_ms": {n[:60]: us / 1e3
                                         for n, us, _ in kernels[:8]},
                      "dense_topk_sweep_ms": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
