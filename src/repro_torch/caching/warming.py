"""Speculative cache warming — precomputation as an operational tool.

Counterpart of ``repro.caching.warming``.  The paper's central device is
*precomputation*: express the pipeline end-to-end, compute the
expensive stages ahead of time, serve the rest from caches.
``warm_scenario`` packages that as an offline job: it builds the named
serving scenario (``serve/registry.py``), compiles its pipeline through
the same plan stack a
:class:`~repro_torch.serve.service.PipelineService` would — identical
expression, identical node fingerprints, identical cache directories —
and drives :meth:`~repro_torch.core.plan.ExecutionPlan.warm` over the
scenario's expected traffic distribution (``warming_frame`` simulates
the closed-loop generator's zipf draws).  A service later opened over
the same ``cache_dir`` with matching scenario parameters starts warm:
its first requests are all cache hits, collapsing cold-start tail
latency (``chip_smoke.py``'s serve phase checks it on the card).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["warm_scenario"]


def warm_scenario(scenario: Any, cache_dir: str, *,
                  config: Any = None,
                  queries: Any = None,
                  budget: Optional[int] = None,
                  backend: Optional[str] = None,
                  cache_budget: Any = None,
                  requests: int = 512, clients: int = 4,
                  scale: float = 0.05, cutoff: int = 10,
                  num_results: int = 100, seed: int = 0,
                  batch_size: Optional[int] = None,
                  chunk_rows: Optional[int] = None,
                  on_stale: str = "error",
                  device: Any = None) -> Dict[str, Any]:
    """Precompute a serving scenario's caches offline.

    Parameters
    ----------
    scenario:
        A scenario name (``"bm25"`` / ``"bm25-mono"`` / ``"mono"`` /
        ...) or an already-built
        :class:`~repro_torch.serve.registry.ServeScenario`.
        Names are built with ``scale``/``cutoff``/``num_results``/
        ``seed`` — these MUST match the later serve invocation, or the
        node fingerprints (and hence cache directories) will differ —
        and on ``device`` (CUDA unless ``"cpu"``).
    config:
        A :class:`~repro_torch.serve.config.ServeConfig` (or kwargs
        dict) supplying the scenario identity and cache plumbing in one
        object — the same config a later ``build_service`` call
        consumes, which removes the "parameters must match" failure
        mode by construction.  When given it overrides ``scale``/
        ``cutoff``/``num_results``/``seed``/``backend``/``on_stale``/
        ``device`` (and ``scenario``, when that is ``None``).
    cache_dir / backend:
        Where the planner-inserted caches live and which store backs
        them — again forwarded exactly as ``repro_torch.cli serve``
        would.
    queries:
        Optional explicit warming frame (anything
        ``ColFrame.coerce`` accepts, rows of qid/query[/extras]).
        Default: ``warming_frame(...)`` — the scenario's own expected
        traffic distribution, hottest queries first.
    budget:
        Warm only the ``budget`` most-expected queries (``None`` =
        the whole topic pool, guaranteeing a subsequent matching serve
        run has zero misses).
    cache_budget:
        Optional per-node size/TTL envelope recorded into the freshly
        warmed manifests (``economics.CacheBudget`` / dict / int).
    chunk_rows:
        Warm in qid-aligned chunks of at most this many rows
        (bounded-memory warming of large logs).

    Returns a report dict (queries warmed, per-run cache hit/miss
    counts, wall time) suitable for ``--json`` output.
    """
    # imports deferred: this module is reachable from `repro_torch.caching`,
    # which core/plan itself imports — resolving the plan/serve stack
    # lazily keeps the package import-cycle free
    from ..core.frame import ColFrame
    from ..core.plan import ExecutionPlan
    from ..serve.config import ServeConfig
    from ..serve.registry import ServeScenario, warming_frame

    if config is not None:
        cfg = ServeConfig.coerce(config)
        backend = cfg.backend if backend is None else backend
        on_stale = cfg.on_stale
        seed = cfg.seed
    else:
        cfg = ServeConfig(
            pipeline=scenario if isinstance(scenario, str) else "bm25-mono",
            scale=scale, cutoff=cutoff, num_results=num_results,
            seed=seed, cache_dir=cache_dir, backend=backend,
            on_stale=on_stale, device=device)
    if not isinstance(scenario, ServeScenario):
        if scenario is not None and str(scenario) != cfg.pipeline:
            cfg = dataclasses.replace(cfg, pipeline=str(scenario))
        scenario = cfg.build_scenario()
    if queries is None:
        frame = warming_frame(scenario, budget=budget,
                              n_requests=requests, n_clients=clients,
                              seed=seed)
    else:
        frame = ColFrame.coerce(queries)
        if budget is not None:
            frame = frame.take(np.arange(min(int(budget), len(frame))))

    t0 = time.perf_counter()
    plan = ExecutionPlan([scenario.pipeline], cache_dir=cache_dir,
                         cache_backend=backend, on_stale=on_stale,
                         cache_budget=cache_budget)
    try:
        stats = plan.warm(frame, batch_size=batch_size,
                          chunk_rows=chunk_rows)
    finally:
        plan.close()
    wall = time.perf_counter() - t0
    return {
        "scenario": scenario.name,
        "cache_dir": cache_dir,
        "backend": backend,
        "queries_warmed": int(len(frame)),
        "cache_hits": int(stats.cache_hits),
        "cache_misses": int(stats.cache_misses),
        "nodes_executed": int(stats.nodes_executed),
        "wall_s": round(wall, 4),
    }
