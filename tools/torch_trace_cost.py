#!/usr/bin/env python3
"""What one call of the port's span recorder (``repro_torch.core.trace``)
costs the host, off and on.

Run from the root of a checkout:

    python3 tools/torch_trace_cost.py [--n 200000] [--repeat 7]

Times, with ``timeit`` (best of ``--repeat`` runs of ``--n`` calls), an
empty function (the loop's own cost), ``with trace.span(name)``, the
same with one attribute, and ``trace.count(name)``, first with the
recorder off and then on; the ``on`` figures keep every span (capacity
``n``), so they include the store's append.  Prints one JSON line of
nanoseconds a call, the loop's cost included.  Needs no device.
"""
from __future__ import annotations

import argparse
import json
import sys
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import trace  # noqa: E402


def f_empty():
    pass


def f_span():
    with trace.span("t"):
        pass


def f_span_attr():
    with trace.span("t", pairs=100):
        pass


def f_count():
    trace.count("t", 1)


def _ns(fn, n: int, repeat: int) -> float:
    return min(timeit.repeat(fn, number=n, repeat=repeat)) / n * 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--repeat", type=int, default=7)
    a = ap.parse_args(argv)
    fns = (f_empty, f_span, f_span_attr, f_count)
    out = {f"off.{f.__name__}": _ns(f, a.n, a.repeat) for f in fns}
    for f in fns[1:]:
        trace.enable(capacity=a.n)
        try:
            # one run of n calls, so the store never drops
            out[f"on.{f.__name__}"] = _ns(f, a.n, 1)
        finally:
            trace.disable()
    print(json.dumps({k: round(v, 1) for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
