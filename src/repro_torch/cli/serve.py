"""``repro_torch.cli serve`` — stand up a serving service (or fleet) and
drive it.

Counterpart of ``repro.cli.serve``.  Builds a named pipeline from the
serving registry (``repro_torch.serve.registry``) on ``--device`` (CUDA
unless ``cpu``), compiles it once through the plan compiler, and runs a
closed-loop synthetic request stream against it with N concurrent
client threads:

* ``python -m repro_torch.cli serve --pipeline hybrid --scale 1.0``
* ``python -m repro_torch.cli serve --pipeline bm25 --cache-dir .cache
  --explain --device cpu``
* ``python -m repro_torch.cli serve --pipeline hybrid --scale 1.0
  --workers 2 --drain --json stats.json``

Everything routes through the unified serving surface
(``repro_torch.serve.ServeConfig`` + ``drive_closed_loop``).
``--workers 1`` (default) serves in-process; ``--workers N`` spawns a
multi-process fleet over the same cache directory, one device a worker
(``serve/fleet.py``).  ``--drain`` finishes in-flight work and flushes
the caches (a fleet's workers close their services, refreshing the cache
manifests on disk) and fails unless every worker exited 0.

With ``--cache-dir`` the planner inserts the §4 cache families per node
(provenance manifests are validated once, at service start) so a second
invocation against the same directory starts warm; ``--backend``
accepts any ``caching.select_backend`` selector — ``memory`` alone
enables in-process memoization, ``mmap:sqlite`` serves hits from a
lock-free packed snapshot that every fleet worker maps.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Union

__all__ = ["register", "cmd_serve", "serve_and_drive"]


def _int_or_auto(value: str) -> Union[int, str]:
    if value == "auto":
        return "auto"
    return int(value)


def _float_or_auto(value: str) -> Union[float, str]:
    if value == "auto":
        return "auto"
    return float(value)


def register(subparsers) -> None:
    p = subparsers.add_parser(
        "serve", help="serve a registry pipeline with micro-batching",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pipeline", default="bm25-mono",
                   help="serving pipeline name (see "
                        "repro_torch.serve.registry; "
                        "default: bm25-mono)")
    p.add_argument("--scale", type=float, default=0.05,
                   help="synthetic corpus scale (default 0.05)")
    p.add_argument("--cutoff", type=int, default=10,
                   help="rank cutoff of the retrieval stage")
    p.add_argument("--num-results", type=int, default=100,
                   help="retriever depth before the cutoff (pushdown "
                        "fuses the two)")
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--clients", type=int, default=4,
                   help="closed-loop client threads")
    p.add_argument("--max-batch", type=_int_or_auto, default=16,
                   help="micro-batch flush threshold, or 'auto' to use "
                        "the plan's autotuned value (from the manifest's "
                        "measured occupancy history; needs --cache-dir)")
    p.add_argument("--max-wait-ms", type=_float_or_auto, default=2.0,
                   help="micro-batch flush timeout (ms), or 'auto'")
    p.add_argument("--workers", type=int, default=1,
                   help="worker PROCESSES (1 = in-process service, N>1 = "
                        "multi-process fleet over the shared cache dir)")
    p.add_argument("--exec-workers", type=int, default=4,
                   help="executor thread-pool size per service")
    p.add_argument("--cache-dir", default=None,
                   help="planner cache root (persists across runs; "
                        "shared by all fleet workers)")
    p.add_argument("--backend", default=None,
                   help="cache backend selector (caching.select_backend: "
                        "memory/pickle/dbm/sqlite, tiered:<disk>, "
                        "mmap:<disk>)")
    p.add_argument("--no-optimize", action="store_true",
                   help="serve the naive lowered plan (baseline)")
    p.add_argument("--no-warm-start", action="store_true",
                   help="fleet workers skip replaying expected traffic "
                        "through their plan on start")
    p.add_argument("--drain", action="store_true",
                   help="gracefully drain on shutdown: finish in-flight "
                        "work, flush write-behind queues, refresh "
                        "manifests, assert workers exit 0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="where the encoders and the dense index run "
                        "(default: cuda; 'cpu' to run on the CPU)")
    p.add_argument("--explain", action="store_true",
                   help="print the compiled plan with online latency "
                        "annotations after the run (workers=1 only)")
    p.add_argument("--json", default=None, metavar="PATH", dest="json_out",
                   help="write run statistics as JSON")
    p.set_defaults(func=cmd_serve)


def serve_and_drive(*, pipeline: str, scale: float, cutoff: int,
                    num_results: int, requests: int, clients: int,
                    max_batch: Union[int, str],
                    max_wait_ms: Union[float, str], workers: int = 1,
                    exec_workers: int = 4,
                    cache_dir: Optional[str] = None,
                    backend: Optional[str] = None,
                    optimize: str = "all", seed: int = 0,
                    explain: bool = False, drain: bool = False,
                    device: Optional[str] = None,
                    warm_start: bool = True) -> Dict[str, Any]:
    """Build the scenario, stand the service (or fleet) up, run the
    closed loop, return a JSON-able stats record.  Thin kwargs shim over
    :func:`repro_torch.serve.drive_closed_loop`, with the reference's
    flat signature; ``workers`` counts worker *processes*
    (``exec_workers`` is the per-service thread pool)."""
    from ..serve import ServeConfig, drive_closed_loop

    cfg = ServeConfig(pipeline=pipeline, scale=scale, cutoff=cutoff,
                      num_results=num_results, seed=seed,
                      cache_dir=cache_dir, backend=backend,
                      optimize=optimize, max_batch=max_batch,
                      max_wait_ms=max_wait_ms, exec_workers=exec_workers,
                      workers=workers, warm_start=warm_start,
                      device=device)
    return drive_closed_loop(cfg, requests=requests, clients=clients,
                             explain=explain, drain=drain)


def cmd_serve(args) -> int:
    from ..caching import select_backend, set_digest_device

    if args.backend is not None:
        select_backend(args.backend)     # fail fast on a bad selector
    if args.device == "cpu":
        set_digest_device("cpu")         # plan fingerprints on the CPU too
    record = serve_and_drive(
        pipeline=args.pipeline, scale=args.scale, cutoff=args.cutoff,
        num_results=args.num_results, requests=args.requests,
        clients=args.clients, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, workers=args.workers,
        exec_workers=args.exec_workers,
        cache_dir=args.cache_dir, backend=args.backend,
        optimize="none" if args.no_optimize else "all",
        seed=args.seed, explain=args.explain, drain=args.drain,
        device=args.device, warm_start=not args.no_warm_start)
    explained = record.pop("_explain", None)
    print(f"served {record['requests']} requests from "
          f"{record['clients']} clients in {record['wall_s']}s "
          f"({record['throughput_rps']} req/s, "
          f"workers={record['workers']})")
    print(f"p50={record['p50_ms']:.2f}ms p99={record['p99_ms']:.2f}ms "
          f"hit_rate={record['hit_rate']:.3f} "
          f"occupancy={record['online']['batch_occupancy']:.2f}")
    if "fleet" in record:
        fl = record["fleet"]
        codes = fl["exit_codes"]
        print(f"fleet: respawns={fl['respawns']} "
              f"requeued={fl['requeued']} exit_codes="
              f"{[codes[k] for k in sorted(codes)]}")
        if args.drain and any(c != 0 for c in codes.values()):
            print("drain FAILED: nonzero worker exit code")
            return 1
    if explained is not None:
        print()
        print(explained)
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(record, f, indent=2, sort_keys=True)
        print(f"wrote {args.json_out}")
    return 0
