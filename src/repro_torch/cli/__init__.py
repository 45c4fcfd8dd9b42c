"""``repro_torch`` command line (``python -m repro_torch.cli``).

Counterpart of ``repro.cli``.  Subcommands register themselves on the
top-level parser:

* ``plan`` (``cli/plan.py``) — render recorded execution plans with the
  same ASCII tree as ``ExecutionPlan.explain()``;
* ``serve`` (``cli/serve.py``) — stand up a ``PipelineService`` over a
  registry pipeline and drive it with a closed-loop request stream
  (micro-batching, planner caches, online latency stats);
* ``cache`` — the reference's cache-directory tooling (inspection,
  verification, garbage collection, export/import, warming) is not
  ported yet: it raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

__all__ = ["main", "build_parser", "CACHE_NOT_PORTED"]

#: why ``cache`` is refused
CACHE_NOT_PORTED = (
    "repro_torch.cli cache: the cache-directory tooling (the reference's "
    "cli/cache.py: ls, verify, gc, evict, export/import, warm) is not "
    "ported to repro_torch yet (ROADMAP Queue A item 4); warm a scenario "
    "with repro_torch.caching.warm_scenario")


def _cmd_cache(args) -> int:
    raise NotImplementedError(CACHE_NOT_PORTED)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch",
        description="Precomputation & caching in IR experiments — tooling "
                    "(PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="command", required=True)
    from . import plan as _plan
    from . import serve as _serve
    cache = sub.add_parser("cache", help="not ported yet (raises)")
    cache.add_argument("rest", nargs=argparse.REMAINDER)
    cache.set_defaults(func=_cmd_cache)
    _plan.register(sub)
    _serve.register(sub)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return int(args.func(args) or 0)
