"""``repro_torch`` command line (``python -m repro_torch.cli``).

Counterpart of ``repro.cli``.  Subcommands register themselves on the
top-level parser:

* ``cache`` (``cli/cache.py``) — inspection, verification, warming,
  eviction, garbage collection and export/import of cache directories
  built on the provenance manifests of ``caching/provenance.py``;
* ``plan`` (``cli/plan.py``) — render recorded execution plans with the
  same ASCII tree as ``ExecutionPlan.explain()``;
* ``serve`` (``cli/serve.py``) — stand up a ``PipelineService`` (or a
  fleet of them) over a registry pipeline and drive it with a
  closed-loop request stream (micro-batching, planner caches, online
  latency stats).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch",
        description="Precomputation & caching in IR experiments — tooling "
                    "(PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="command", required=True)
    from . import cache as _cache
    from . import plan as _plan
    from . import serve as _serve
    _cache.register(sub)
    _plan.register(sub)
    _serve.register(sub)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return int(args.func(args) or 0)
