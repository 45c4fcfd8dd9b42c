"""``repro_torch.cli plan`` — inspect recorded execution plans.

Counterpart of ``repro.cli.plan``.  A planner ``cache_dir`` records
every plan that used it under ``plans/<plan_id>.json``
(``core/plan.py``).  ``plan explain`` renders those records with the
*same* renderer as ``ExecutionPlan.explain()``
(``repro_torch.core.ir.render_explain``), so the CLI output round-trips
the in-process one byte-for-byte:

* ``explain ROOT``             — render every recorded plan;
* ``explain ROOT --plan ID``   — render one plan (id prefix accepted);
* ``explain ROOT --json``      — emit the raw record(s) as JSON
  (stable key order) for scripting.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Tuple

from ..caching.provenance import iter_plan_manifests
from ..core.ir import render_explain

__all__ = ["register", "cmd_explain"]


def register(subparsers) -> None:
    p = subparsers.add_parser(
        "plan", help="inspect recorded execution plans",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="plan_command", required=True)

    ex = sub.add_parser(
        "explain", help="render a recorded plan as the explain() tree")
    ex.add_argument("root", help="planner cache_dir (holding plans/*.json)")
    ex.add_argument("--plan", default=None, metavar="ID",
                    help="plan id to render (prefix accepted); "
                         "default: every recorded plan")
    ex.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the raw plan record(s) as JSON")
    ex.set_defaults(func=cmd_explain)


def _load_plans(root: str) -> List[Tuple[str, Dict[str, Any]]]:
    out = []
    for path, doc, err in iter_plan_manifests(os.path.abspath(root)):
        if err is not None:
            raise SystemExit(f"plan explain: {err} ({path})")
        out.append((path, doc))
    return out


def cmd_explain(args) -> int:
    plans = _load_plans(args.root)
    if args.plan is not None:
        plans = [(p, d) for p, d in plans
                 if str(d.get("plan_id", "")).startswith(args.plan)]
    if not plans:
        sel = f" matching {args.plan!r}" if args.plan is not None else ""
        msg = (f"no recorded plan manifests{sel} under {args.root} "
               f"(plans are recorded when ExecutionPlan is given a "
               f"cache_dir)")
        if args.as_json:
            print("[]")                  # stdout stays pure JSON
            print(msg, file=sys.stderr)
        else:
            print(msg)
        return 1
    if args.as_json:
        print(json.dumps([d for _, d in plans], indent=2, sort_keys=True))
        return 0
    for i, (_, doc) in enumerate(plans):
        if i:
            print()
        print(render_explain(doc))
    return 0
