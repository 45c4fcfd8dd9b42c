"""Online serving on top of the plan compiler.

Counterpart of ``repro.serve.service``, in one process (the reference's
multi-process fleet is not ported yet).

The paper's thesis is that pipelines should be *expressed* end-to-end
while caching and precomputation remove the redundant work.  This
module brings that to the online path: :class:`PipelineService` accepts
an **arbitrary** pipeline expression (``bm25 % 100 >> loader >> mono``),
compiles it ONCE through the full compiler stack — lowering
(``core/ir.py``), optimizer passes incl. top-k pushdown and cache-prune
against warm stores (``core/rewrite.py``) — and serves requests through
the incremental scheduler (``core.executor.StreamingExecutor``):

* concurrent client submissions coalesce into micro-batches (bounded
  queue; flush on ``max_batch`` or ``max_wait_ms``) that flow through
  DAG wavefronts, so N in-flight requests sharing a query hit the
  retriever once and the reranker in one encoder batch;
* planner-inserted caches (``cache_dir`` / ``cache_backend``) make
  repeat traffic cheap per-request — the paper's Table-2 mechanism,
  measured at the request level;
* provenance manifests (``caching/provenance.py``) are validated once,
  at service start (plan construction opens every cache and checks its
  manifest) — never per request;
* ``stats`` keeps per-request latency in a bounded reservoir (a
  long-lived service does not grow memory per request) and derives its
  hit/miss totals from *per-call* cache counts, not shared-counter
  deltas.

:class:`ScoringService` — the pre-compiler, single-scorer-stage service
— survives as a thin compatibility front-end over ``PipelineService``.
"""
from __future__ import annotations

import threading
import warnings
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Union

from ..core.executor import Reservoir, StreamingExecutor
from ..core.frame import ColFrame
from ..core.pipeline import Transformer
from ..core.plan import ExecutionPlan, PlanStats

# ScoringService is deprecated and deliberately absent: it still
# imports (one more release) but warns on construction
__all__ = ["PipelineService", "ServiceStats"]


class ServiceStats:
    """Thread-safe request-level statistics.

    Latencies live in a bounded
    :class:`~repro_torch.core.executor.Reservoir`
    (capacity ``reservoir_capacity``), so a long-lived service holds a
    constant amount of memory while p50/p99 stay stable estimates of
    the whole request stream.  They run from ``submit``: the service
    cannot know when a client meant to send a request, so an open-loop
    client reports its own lateness on top.  Hit/miss totals are accumulated from
    per-call cache counts (``CacheTransformer.pop_call_counts``), which
    stay correct when several threads or services share one cache.
    """

    def __init__(self, reservoir_capacity: int = 4096):
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.latencies = Reservoir(reservoir_capacity)

    # -- updates -------------------------------------------------------------
    def record_batch(self, *, n_requests: int,
                     latencies_ms: Sequence[float] = ()) -> None:
        with self._lock:
            self.requests += int(n_requests)
            self.batches += 1
        self.latencies.extend(latencies_ms)

    def add_cache_counts(self, hits: int, misses: int) -> None:
        with self._lock:
            self.cache_hits += int(hits)
            self.cache_misses += int(misses)

    # -- views ---------------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        lookups = self.cache_hits + self.cache_misses
        return self.cache_hits / lookups if lookups else 0.0

    def percentile(self, p: float) -> float:
        return self.latencies.percentile(p)

    def summary(self) -> Dict[str, float]:
        return {"requests": self.requests, "batches": self.batches,
                "hit_rate": self.hit_rate,
                "p50_ms": self.percentile(50), "p99_ms": self.percentile(99)}


class PipelineService:
    """Serve an arbitrary pipeline expression, compiled once.

    Parameters
    ----------
    pipeline:
        Any operator-algebra expression (``core/pipeline.py``).
    cache_dir / cache_backend / on_stale / optimize:
        Forwarded to :class:`~repro_torch.core.plan.ExecutionPlan` — the
        service compiles ``[pipeline]`` through the full stack at
        construction time.  Provenance manifests are therefore checked
        exactly once, at service start.  ``cache_backend="memory"``
        alone enables in-process memoization; a ``cache_dir`` persists
        caches across service restarts (warm starts).
    max_batch / max_wait_ms:
        Micro-batching knobs: a batch dispatches when ``max_batch``
        requests are pending or ``max_wait_ms`` after its first
        request, whichever first.  ``max_wait_ms=0`` disables the
        batching delay (each dispatch takes whatever is queued).
        Either knob accepts ``"auto"``: the value the compiled plan's
        ``autotune`` pass derived from the manifest's measured
        batch-occupancy / queue-depth history (falling back to the
        defaults when there is no evidence yet).  Each service run
        records its online stats back into the plan manifest on
        ``close()``, so an ``"auto"`` service self-tunes across
        restarts.
    max_workers:
        Thread-pool size of the streaming executor (DAG branches and
        in-flight micro-batches run concurrently on it).
    queue_capacity:
        Bound of the submission queue; ``submit`` blocks when full
        (backpressure instead of unbounded buffering).
    """

    def __init__(self, pipeline: Transformer, *,
                 cache_dir: Optional[str] = None,
                 cache_backend: Optional[str] = None,
                 on_stale: str = "error",
                 optimize: Union[str, Sequence[str], None] = "all",
                 max_batch: Union[int, str] = 32,
                 max_wait_ms: Union[float, str] = 2.0,
                 max_workers: int = 4, queue_capacity: int = 1024,
                 batch_size: Optional[int] = None,
                 reservoir_capacity: int = 4096,
                 prefetch: bool = True):
        self.pipeline = pipeline
        self.plan = ExecutionPlan([pipeline], cache_dir=cache_dir,
                                  cache_backend=cache_backend,
                                  on_stale=on_stale, optimize=optimize,
                                  prefetch=prefetch)
        tuned = self.plan.tuning()
        if max_batch == "auto":
            max_batch = int(tuned.get("max_batch", 32))
        if max_wait_ms == "auto":
            max_wait_ms = float(tuned.get("max_wait_ms", 2.0))
        self.stats = ServiceStats(reservoir_capacity)
        self._exec = StreamingExecutor(
            self.plan.graph, batch_size=batch_size, max_batch=max_batch,
            max_wait_ms=max_wait_ms, max_workers=max_workers,
            queue_capacity=queue_capacity, on_batch=self._on_batch)
        self.max_batch = self._exec.max_batch
        self.max_wait_ms = float(max_wait_ms)
        self._compute_base = self.plan._compute_counters()
        self._cache_base = self.plan._cache_counters()
        self._closed = False

    # -- request path --------------------------------------------------------
    def submit(self, qid: Any, query: str, **extra: Any) -> Future:
        """Asynchronously serve one query; resolves to the pipeline's
        result frame for this qid.  Concurrent submissions coalesce
        into micro-batches (identical (qid, query) submissions share
        one execution)."""
        row = {"qid": str(qid), "query": query, **extra}
        return self._exec.submit([row])

    def search(self, queries: Any, timeout: Optional[float] = None
               ) -> ColFrame:
        """Synchronously serve a query frame (one request, possibly
        many qids); dispatches immediately."""
        frame = ColFrame.coerce(queries)
        fut = self._exec.submit(frame.to_dicts())
        self._exec.flush()
        return fut.result(timeout)

    def flush(self) -> None:
        """Dispatch pending submissions without waiting for the batch
        window."""
        self._exec.flush()

    def drain(self) -> None:
        """Make the service's caches durable without stopping it: flush
        each planner-inserted cache's write-behind queue and access log
        (``caching/dataplane.py``).  Long-lived services call this at
        quiet points; ``close()`` always drains."""
        self.plan.drain()

    # -- stats / introspection -----------------------------------------------
    def _on_batch(self, *, n_requests: int, latencies_ms: List[float],
                  cause: str, cache_hits: int = 0,
                  cache_misses: int = 0) -> None:
        self.stats.record_batch(n_requests=n_requests,
                                latencies_ms=latencies_ms)
        self.stats.add_cache_counts(cache_hits, cache_misses)

    @property
    def online_stats(self):
        """The streaming executor's :class:`StreamStats` (flush
        triggers, queue depth, batch occupancy, per-node latency)."""
        return self._exec.stats

    def plan_stats(self) -> PlanStats:
        """Optimizer accounting plus ONLINE execution statistics: how
        often each plan node ran, its p50/p99 latency, queue depth and
        micro-batch occupancy — the serving analogue of the stats an
        offline ``plan.run`` returns."""
        stats = self.plan._new_stats()
        s = self._exec.stats
        per_node = s.node_dicts()
        stats.node_exec_counts = {label: int(d["executions"])
                                  for label, d in per_node.items()}
        # approximate total per-node seconds from the online latency
        # reservoirs (executions × p50) — what _record_run folds into
        # the manifest's measured cost table, so a served plan's costs
        # inform the next compile exactly like an offline run's
        stats.node_times_s = {
            label: int(d["executions"]) * float(d["p50_ms"]) / 1e3
            for label, d in per_node.items() if d["executions"]}
        stats.n_queries = int(s.requests)
        stats.nodes_executed = len(per_node)
        # cached nodes fold their raw miss-path compute time instead of
        # the store-dominated wrapper latency (see cost.fold_costs)
        self.plan._fill_compute_stats(stats, self._compute_base)
        stats.cache_hits = s.cache_hits
        stats.cache_misses = s.cache_misses
        # staged-served subset of the hits (dataplane prefetch) — read
        # from the family counters, which attribute a prefetched hit to
        # the *consuming* node at consumption time, so it is always a
        # subset of the hits counted above (never an extra lookup)
        stats.cache_prefetched = \
            self.plan._cache_counters()[2] - self._cache_base[2]
        stats.online = s.as_dict(self.max_batch)
        stats.online.setdefault("max_batch", self.max_batch)
        stats.online.setdefault("max_wait_ms", self.max_wait_ms)
        return stats

    def explain(self) -> str:
        """The compiled plan's ``explain()`` tree, annotated per node
        with online latency (``online[p50=.. p99=.. n=..]``), plus a
        service summary line."""
        import copy

        from ..core.ir import render_explain
        record = copy.deepcopy(self.plan.to_record())
        per_node = self._exec.stats.node_dicts()
        for n in record["nodes"]:
            onl = per_node.get(n["label"])
            if onl:
                n["online"] = onl
        s = self._exec.stats
        tail = (f"online: requests={s.requests} batches={s.batches} "
                f"occupancy={s.occupancy(self.max_batch):.2f} "
                f"queue_p99={s.queue_depth.percentile(99):.1f} "
                f"flush[size={s.flush_size} timeout={s.flush_timeout} "
                f"forced={s.flush_forced}] "
                f"hits={s.cache_hits} misses={s.cache_misses}")
        return render_explain(record) + "\n" + tail

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._exec.close()
        if self.plan._plan_manifest_path is not None \
                and self._exec.stats.requests:
            try:
                # persist this service run (incl. online batch stats) to
                # the plan manifest: the next compile's autotune pass
                # reads it back — this is what makes "auto" self-tuning
                self.plan._record_run(self.plan_stats())
            except Exception:
                pass
        self.plan.close()

    def __enter__(self) -> "PipelineService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class ScoringService:
    """DEPRECATED compatibility front-end: the paper's §4.2
    single-scorer service (``index.bm25() >> cached_scorer`` packaged
    as a long-lived service), now a thin wrapper over
    :class:`PipelineService`.

    Construction emits a :class:`DeprecationWarning`; the import
    survives one more release, but the class is no longer part of
    ``serve.__all__``.  Use ``PipelineService`` (optionally wrapping
    the scorer in a ``ScorerCache``) — it serves whole pipelines and
    micro-batches concurrent clients.
    """

    def __init__(self, scorer: Transformer,
                 cache_path: Optional[str] = None,
                 max_batch: int = 256, use_cache: bool = True):
        warnings.warn(
            "ScoringService is deprecated and will be removed in the next "
            "release; wrap the scorer in a ScorerCache and serve it with "
            "PipelineService (or serve.build_service)",
            DeprecationWarning, stacklevel=2)
        from ..caching.scorer import ScorerCache
        self.scorer = scorer
        self.cache = ScorerCache(cache_path, scorer) if use_cache else None
        stage = self.cache if self.cache is not None else scorer
        self.max_batch = int(max_batch)
        self._svc = PipelineService(stage, max_batch=self.max_batch,
                                    max_wait_ms=0.0, max_workers=1)
        self._queue: List[Dict] = []

    @property
    def stats(self) -> ServiceStats:
        return self._svc.stats

    def submit(self, qid: str, query: str, docno: str, text: str) -> None:
        self._queue.append({"qid": qid, "query": query, "docno": docno,
                            "text": text, "score": 0.0, "rank": 0})

    def flush(self) -> ColFrame:
        """Score everything queued; returns the scored frame."""
        if not self._queue:
            return ColFrame()
        outs = []
        while self._queue:
            chunk, self._queue = (self._queue[:self.max_batch],
                                  self._queue[self.max_batch:])
            outs.append(self._svc.search(chunk))
        return ColFrame.concat(outs)

    def close(self):
        self._svc.close()
        if self.cache is not None:
            self.cache.close()
