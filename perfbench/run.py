"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs a CUDA device (one card per cell).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; its last key,
``checks``, holds each number the judge compared beside its limit, and
the same numbers end standard error.

``--control tf32`` runs the program with TF32 matrix products allowed,
the lower precision the judge has to catch; ``--rate`` overrides the
open-loop rate for a sweep.  Neither is used by the cells' own runs.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """The benchmark and the port on the path; kernel caches at fixed
    directories inside the checkout."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--rate", type=float, default=None)
    a = ap.parse_args(argv)

    import torch
    from perfbench import harness

    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("perfbench: no CUDA device; the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if a.rate is not None:
        cell.traffic["rate_per_s"] = a.rate
    out = harness.run_cell(cell, seed=a.seed, seconds=a.seconds,
                           trace=bool(a.trace), device="cuda",
                           t_start=T_START, control=a.control)
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    _environment()
    sys.exit(main())
