#!/usr/bin/env python3
"""The ``embedding_bag`` kernel of one ``repro_torch`` tree, timed on one
GPU at the timed rows of ``chip_smoke.py``'s ``EB_ROWS``
(``benchmarks/kernels_bench.py``'s two shapes, MIND's serving batch in
f32 and bf16).

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/torch_embedding_bag_bench.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(this checkout's by default), so that two trees, say a parent commit
unpacked by ``git archive`` and the change, are compared in one call on
one card, run in turns as separate processes.  The timing helpers and
the rows are this checkout's ``chip_smoke.py``.  Only the entry points
that every version has are called: the wrapper
``embedding_bag(table, ids, weights)`` (the sum) and
``embedding_bag_op(..., combiner=...)``.

Per row: CUDA-event ms with the L2 flushed (median of 20); the kernel's
device-only ms from ``torch.profiler``, with the L2 flushed before each
call and warm; ``F.embedding_bag``'s event ms and device-only ms (all
its kernels, L2 flushed); the bytes bound.  At MIND's rows also the
host's enqueue per wrapper call (and, in a tree whose wrapper has
``launch_args``, of the bare ``ctypes`` call) and, for the op with the
row's combiner, the kernels the profiler counts in one call and their
device-only ms.  One JSON line per row; exits 1 without a CUDA device.

``--sweep`` times instead, at each row, the kernel's device-only ms
(L2 flushed) under every vector width, rows-in-flight U and warps a
block (1 or 4) that the kernel takes, in place of what ``kernel.plan``
picks: the measurement behind ``plan``'s constants.  ``--probe`` times
the kernel as planned at MIND's B 512 while the table's rows V (8,192:
2 MB in f32; 1M; 4M), the bag length L and the number of bags B change,
L2 flushed and warm: how the time splits between the rows' latency,
their number and the card's bandwidth.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_embedding_bag_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_op,
                                                   embedding_bag_ref)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    mod = sys.modules[embedding_bag.__module__]
    print(f"{args.label}: {mod.__name__} from {args.src}; {card}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    if args.probe:
        probe(torch, gen, embedding_bag, args.label, card)
        return 0
    for label, V, d, B, L, weights, combiner, dt in chip_smoke.EB_ROWS:
        if label == "sweep":
            continue
        tab = torch.randn(V, d, generator=gen, device="cuda",
                          dtype=getattr(torch, dt))
        ids, w = chip_smoke.bag_inputs(torch, gen, tab, B, L, weights)
        err = float((embedding_bag_op(tab, ids, w, combiner=combiner).float()
                     - embedding_bag_ref(tab, ids, w, combiner).float())
                    .abs().max())
        if not err <= chip_smoke.TOL_BAG[dt]:
            raise AssertionError(f"{label}: max_abs_err {err}")
        ids64 = ids.long()

        def kernel():
            return embedding_bag(tab, ids, w)

        def library():
            return F.embedding_bag(ids64, tab, mode="sum",
                                   per_sample_weights=w)
        if args.sweep:
            sweep(torch, mod, args.label, label, dt, tab, ids, kernel, card)
            continue
        row = {"tree": args.label, "row": label, "shape": [V, d, B, L],
               "dtype": dt, "weights": weights, "max_abs_err": err,
               "ms": chip_smoke.time_ms(torch, kernel),
               "device_ms": chip_smoke.device_ms(
                   torch, kernel, "embedding_bag_kernel", flush_l2=True),
               "device_ms_l2_warm": chip_smoke.device_ms(
                   torch, kernel, "embedding_bag_kernel"),
               "library_ms": chip_smoke.time_ms(torch, library),
               "library_device_ms": sum(ms for ms, _ in
                                        chip_smoke.profile_kernels(
                                            torch, library,
                                            flush_l2=True).values())}
        row["bound_ms"], row["bound_by"], row["rows"] = \
            chip_smoke.bag_bound(torch, tab, ids, w)
        if label.startswith("MIND"):
            row["host_us"] = chip_smoke.host_us(torch, kernel)
            launch_args = getattr(mod, "launch_args", None)
            if launch_args is not None:
                call = launch_args(tab, ids, w)
                row["bare_call_us"] = chip_smoke.host_us(
                    torch, lambda: call.entry(*call.args))
            ks = chip_smoke.profile_kernels(
                torch, lambda: embedding_bag_op(tab, ids, w,
                                                combiner=combiner),
                flush_l2=True)
            row[f"op_{combiner}_kernels"] = sum(n for _, n in ks.values())
            row[f"op_{combiner}_device_ms"] = sum(ms for ms, _ in
                                                  ks.values())
        print(f"{args.label}: {label} {dt}: kernel {row['ms']:.4f} ms, "
              f"device-only {chip_smoke.fmt_ms(row['device_ms'])} (L2 "
              f"warm {chip_smoke.fmt_ms(row['device_ms_l2_warm'])}), "
              f"F.embedding_bag {row['library_ms']:.4f} ms (device-only "
              f"{row['library_device_ms']:.4f} ms), bound "
              f"{row['bound_ms'] * 1e3:.4f} us; {card}", flush=True)
        print(json.dumps(row), flush=True)
        del tab, ids, ids64, w
        torch.cuda.empty_cache()
    return 0


def sweep(torch, mod, tree, label, dt, tab, ids, kernel, card) -> None:
    """Device-only ms of ``kernel`` under each (U, warps a block), with
    the other fields of the plan of ``mod`` (the wrapper's module)
    kept."""
    planned = mod.plan
    V, d = tab.shape
    B, L = ids.shape
    p0 = planned(V, d, B, L, tab.dtype, mod.alignment(tab))
    row, align = d * tab.element_size(), mod.alignment(tab)
    widths = [w for w in (tab.element_size(), 4, 8, 16)
              if w >= tab.element_size() and row % w == 0 and align % w == 0]
    times = {}
    try:
        for vec in sorted(set(widths)):
            groups = -(-row // (32 * vec))
            lanes = -(-(row // vec) // groups)
            u = 1
            while u <= mod.MAX_U:
                for warps in (1, 4):
                    if warps * u * lanes * vec > mod.RING_BYTES:
                        continue
                    p = p0._replace(vec=vec, rows_in_flight=u, warps=warps,
                                    groups=groups)
                    mod.plan = lambda *a, p=p: p
                    times[f"vec{vec} U{u} w{warps}"] = chip_smoke.device_ms(
                        torch, kernel, "embedding_bag_kernel", flush_l2=True)
                u *= 2
    finally:
        mod.plan = planned
    best = min(times, key=lambda k: times[k] or float("inf"))
    print(f"{tree}: sweep {label} {dt} (plan vec{p0.vec} "
          f"U{p0.rows_in_flight} w{p0.warps}): best {best} "
          f"{times[best]:.5f} ms; {card}", flush=True)
    print(json.dumps({"tree": tree, "row": label, "dtype": dt,
                      "plan": p0._asdict(), "device_ms": times}), flush=True)


def probe(torch, gen, embedding_bag, tree, card) -> None:
    """Device-only ms of the planned kernel at d 64, no weights, over
    table rows V, bag lengths L and bags B (512 unless named)."""
    d = 64
    shapes = [(V, 50, 512, dt) for dt in ("float32", "bfloat16")
              for V in (8192, 1_000_000, 4_000_000)]
    shapes += [(1_000_000, L, 512, "float32")
               for L in (1, 2, 8, 16, 32, 64, 128)]
    shapes += [(1_000_000, 50, B, "float32") for B in (132, 2048)]
    for V, L, B, dt in shapes:
        tab = torch.randn(V, d, generator=gen, device="cuda",
                          dtype=getattr(torch, dt))
        ids = torch.randint(0, V, (B, L), generator=gen, device="cuda",
                            dtype=torch.int32)

        def kernel():
            return embedding_bag(tab, ids)
        row = {"tree": tree, "probe": [V, d, B, L], "dtype": dt,
               "device_ms": chip_smoke.device_ms(
                   torch, kernel, "embedding_bag_kernel", flush_l2=True),
               "device_ms_l2_warm": chip_smoke.device_ms(
                   torch, kernel, "embedding_bag_kernel")}
        print(f"{tree}: probe V={V} L={L} B={B} {dt}: device-only "
              f"{chip_smoke.fmt_ms(row['device_ms'])} (L2 warm "
              f"{chip_smoke.fmt_ms(row['device_ms_l2_warm'])}); {card}",
              flush=True)
        print(json.dumps(row), flush=True)
        del tab, ids
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
