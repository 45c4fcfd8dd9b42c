"""Physical executors for optimized plan graphs (``core/ir.py``).

Counterpart of ``repro.core.executor``: the third layer of the plan
compiler, schedulers that evaluate a
:class:`~repro_torch.core.ir.PlanGraph` over a query frame.  Three are
provided; the offline two have identical semantics:

* :func:`run_sequential` — recursive post-order evaluation, one node at
  a time, results memoized per node instance;
* :func:`run_concurrent` — the sharded wavefront scheduler: the query
  frame is partitioned into qid-aligned shards and (node, shard) tasks
  run on a thread pool as their per-shard inputs complete;
* :class:`StreamingExecutor` — the *online* mode: long-lived, fed by
  concurrent request submissions that coalesce into micro-batches
  (bounded queue, flush on ``max_batch`` or ``max_wait_ms``), each
  flowing through the same DAG wavefront machinery as the offline
  scheduler — a micro-batch takes the structural place of a shard, so
  several batches can be in flight at different depths of the DAG.

All executors understand the ``cache-prune`` annotations of
``core/rewrite.py``: a node with a ``probe_input`` is evaluated
*lookup-first* — its memo cache is probed with the deferred chain's
input, and the chain (``inline_chain``) only executes when the store
cannot serve every key.  Deferred nodes are excluded from normal
scheduling; they run inline inside their consumer's task.

Scheduling invariants: every node runs **at most once per shard**
(results are memoized per node instance, never recomputed for a second
consumer); tasks are dispatched in **topological wavefronts**, so a
node's inputs are complete frames before it runs; and the query frame
is partitioned only along **qid-aligned boundaries** and only when
every stage in the graph is ``shardable`` (row-local per qid) — a
single non-shardable stage collapses execution to one shard, leaving
branch parallelism only.  Under these rules the sequential and
concurrent schedulers are observationally identical.

Executor threads carry no torch state of their caller: the encoders
enter ``inference_mode`` themselves and every tensor names its device,
so a stage runs the same on a pool thread as on the main thread.
"""
from __future__ import annotations

import heapq
import queue as queue_mod
import random
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .frame import ColFrame
from .ir import IRNode, PlanGraph
from .precompute import _run_stage

__all__ = ["run_sequential", "run_concurrent", "run_warm",
           "resolve_n_shards", "Reservoir", "NodeOnlineStats",
           "StreamStats", "StreamingExecutor"]


def _qid_runs_unique(qids: np.ndarray) -> bool:
    """True when every qid forms one contiguous run — the property that
    makes cutting at run boundaries preserve per-qid semantics."""
    n = len(qids)
    if n == 0:
        return True
    arr = qids
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        arr = arr.astype(str)
    change = np.empty(n, dtype=bool)
    change[0] = True
    change[1:] = arr[1:] != arr[:-1]
    return int(change.sum()) == len(np.unique(arr))


def _shard_bounds(frame: ColFrame, n_shards: int) -> List[Tuple[int, int]]:
    """Partition ``frame`` into ≤ ``n_shards`` contiguous row ranges,
    cutting only at qid-run boundaries so no query straddles a shard."""
    n = len(frame)
    if n == 0 or n_shards <= 1:
        return [(0, n)]
    if "qid" in frame:
        q = frame["qid"]
        arr = q.astype(str) if q.dtype == object or q.dtype.kind in ("U", "S") \
            else q
        cuts = np.nonzero(arr[1:] != arr[:-1])[0] + 1
    else:
        cuts = np.arange(1, n)
    sel: List[int] = []
    prev = 0
    for i in range(1, n_shards):
        target = round(i * n / n_shards)
        j = int(np.searchsorted(cuts, max(target, prev + 1)))
        cands = []
        if j < len(cuts):
            cands.append(int(cuts[j]))
        if j > 0 and int(cuts[j - 1]) > prev:
            cands.append(int(cuts[j - 1]))
        if not cands:
            continue
        c = min(cands, key=lambda x: abs(x - target))
        if prev < c < n:
            sel.append(c)
            prev = c
    bounds = [0] + sel + [n]
    return list(zip(bounds[:-1], bounds[1:]))


def resolve_n_shards(graph: PlanGraph, frame: ColFrame,
                     batch_size: Optional[int],
                     n_shards: Optional[int],
                     max_workers: Optional[int]) -> int:
    n = len(frame)
    if n == 0:
        return 1
    if n_shards is not None:
        want = int(n_shards)
    elif max_workers is not None and int(max_workers) > 1:
        want = -(-n // int(batch_size)) if batch_size else int(max_workers)
    else:
        return 1
    want = max(1, min(want, n))
    if want > 1 and not all(node.shardable for node in graph.nodes
                            if node.kind == "stage"):
        # a stage declared shardable=False (cross-query statistics);
        # partitioning the frame would change its results.  Keep one
        # shard (branch-level parallelism via max_workers still applies).
        return 1
    if want > 1 and "qid" in frame and not _qid_runs_unique(frame["qid"]):
        # a qid with non-contiguous rows cannot be cut without
        # splitting its group; keep one shard
        return 1
    return want


def _exec_node(node: IRNode, ins: List[ColFrame],
               batch_size: Optional[int]) -> ColFrame:
    if node.kind == "stage":
        runner = node.cache if node.cache is not None else node.stage
        if not node.shardable:
            # batching partitions the frame exactly like sharding
            # would — a cross-query stage must see it whole
            return runner(ins[0])
        return _run_stage(runner, ins[0], batch_size)
    if node.kind == "scale":
        return node.stage.apply(ins[0])
    return node.stage.combine(ins[0], ins[1])              # combine


class _Recorder:
    """Thread-safe (label, shard, t0, t1) execution records."""

    def __init__(self) -> None:
        self.records: List[Tuple[str, int, float, float]] = []
        self._lock = threading.Lock()

    def add(self, label: str, shard: int, t0: float, t1: float) -> None:
        with self._lock:
            self.records.append((label, shard, t0, t1))


class _NullRecorder(_Recorder):
    """Drops records — the streaming executor keeps bounded per-node
    reservoirs instead of an ever-growing record list."""

    def add(self, label: str, shard: int, t0: float, t1: float) -> None:
        pass


_NULL_RECORDER = _NullRecorder()


def _effective_inputs(node: IRNode) -> List[IRNode]:
    """The inputs a scheduler must wait for.  Cache-prune: a probing
    node waits on the deferred chain's *input*; the chain itself runs
    inline inside this node's task."""
    if node.probe_input is not None and node.cache is not None:
        return [node.probe_input]
    return node.inputs


def _wave_edges(graph: PlanGraph
                ) -> Tuple[List[IRNode], Dict[int, List[IRNode]]]:
    """(schedulable nodes, input-id → consumers) — the wavefront edge
    structure shared by the offline sharded scheduler and the streaming
    executor.  Nodes are addressed by instance id throughout."""
    schedulable = [n for n in graph.nodes
                   if n.kind != "source" and not n.inlined]
    children: Dict[int, List[IRNode]] = {}
    for node in schedulable:
        for inp in _effective_inputs(node):
            children.setdefault(inp.id, []).append(node)
    return schedulable, children


def _exec_with_probe(node: IRNode, probe_frame: ColFrame,
                     batch_size: Optional[int], shard: int,
                     rec: _Recorder) -> ColFrame:
    """Lookup-first evaluation of a cache-prune annotated node: serve
    from the warm store keyed off ``probe_frame``; on any miss, execute
    the deferred chain to build the node's real input, then run the
    memoized stage normally."""
    t0 = time.perf_counter()
    out = node.cache.serve_from_store(probe_frame)
    if out is not None:
        rec.add(node.label, shard, t0, time.perf_counter())
        return out
    v = probe_frame
    for ch in node.inline_chain:
        t1 = time.perf_counter()
        v = _exec_node(ch, [v], batch_size)
        rec.add(ch.label, shard, t1, time.perf_counter())
    t1 = time.perf_counter()
    out = _exec_node(node, [v], batch_size)
    rec.add(node.label, shard, t1, time.perf_counter())
    return out


class _Prefetcher:
    """Issues cache ``get_many`` calls on the I/O pool the moment a
    node's keys are knowable, for every plan node stamped ``prefetch``.

    A cache's keys derive from the frame its node consumes
    (``prefetch_columns``), so the fetch can start when that *feeding*
    node completes: for query-keyed families fed by the source
    (retrievers, probe nodes) that is submit time — the reads overlap
    wave-0 compute — and for doc-keyed families (``ScorerCache``) it is
    the upstream retriever's completion, overlapping sibling branches.
    The executors call :meth:`node_ready` for the source and after
    every node; the mapping here decides which caches that feeds.

    Results land in each cache's staging map; the consuming
    ``transform``/``serve_from_store`` pops them, so accounting and
    compute-once semantics are untouched (see ``caching/dataplane.py``).
    """

    def __init__(self, graph: PlanGraph):
        #: feeding-node id → [(consumer node, its cache)]
        self._by_feed: Dict[int, List[Tuple[IRNode, Any]]] = {}
        for node in graph.nodes:
            if node.kind != "stage" or node.inlined or not node.prefetch:
                continue
            cache = node.cache
            if cache is None or not getattr(cache, "prefetchable", False):
                continue
            cols = cache.prefetch_columns() \
                if hasattr(cache, "prefetch_columns") else None
            if not cols:
                continue
            feeds = _effective_inputs(node)
            if len(feeds) != 1:
                continue
            self._by_feed.setdefault(feeds[0].id, []).append((node, cache))

    @classmethod
    def for_graph(cls, graph: PlanGraph) -> Optional["_Prefetcher"]:
        pf = cls(graph)
        return pf if pf._by_feed else None

    def node_ready(self, node_id: int, frame: ColFrame) -> None:
        """``node_id``'s output exists — start fetching for every cache
        it feeds whose key columns the frame carries.  Pass the source
        id at submit time to kick off query-keyed prefetches."""
        for _, cache in self._by_feed.get(node_id, ()):
            cols = cache.prefetch_columns()
            if cols and all(c in frame for c in cols):
                try:
                    cache.prefetch_async(frame)
                except Exception:
                    pass                 # a failed prefetch is a non-fetch

    def close(self) -> None:
        """Run teardown: drop staged entries nobody consumed."""
        for entries in self._by_feed.values():
            for _, cache in entries:
                try:
                    cache.discard_staging()
                except Exception:
                    pass


def run_sequential(graph: PlanGraph, frame: ColFrame,
                   batch_size: Optional[int],
                   rec: Optional[_Recorder] = None) -> List[ColFrame]:
    """Evaluate all terminals over ``frame``; returns per-pipeline
    results.  Execution records accumulate into ``rec``."""
    rec = rec if rec is not None else _Recorder()
    results: Dict[int, ColFrame] = {graph.source.id: frame}
    pf = _Prefetcher.for_graph(graph)

    def evaluate(node: IRNode) -> ColFrame:
        memo = results.get(node.id)
        if memo is not None:
            return memo
        if node.probe_input is not None and node.cache is not None:
            out = _exec_with_probe(node, evaluate(node.probe_input),
                                   batch_size, 0, rec)
        else:
            ins = [evaluate(i) for i in node.inputs]
            t0 = time.perf_counter()
            out = _exec_node(node, ins, batch_size)
            rec.add(node.label, 0, t0, time.perf_counter())
        results[node.id] = out
        if pf is not None:
            pf.node_ready(node.id, out)
        return out

    try:
        if pf is not None:
            # query-keyed prefetches start before any compute: sibling
            # pipelines' store reads overlap the first chain's work
            pf.node_ready(graph.source.id, frame)
        return [evaluate(t) for t in graph.terminals]
    finally:
        if pf is not None:
            pf.close()


def run_warm(graph: PlanGraph, frame: ColFrame,
             batch_size: Optional[int] = None, *,
             chunk_rows: Optional[int] = None,
             rec: Optional[_Recorder] = None) -> int:
    """Offline cache warming: evaluate every terminal over ``frame``
    purely for the side effect of populating memo caches; outputs are
    discarded chunk by chunk.

    With ``chunk_rows``, the frame is cut into qid-aligned chunks of
    roughly that many rows (the same boundary logic as the sharded
    scheduler), so warming an arbitrarily large query log holds at most
    one chunk of intermediates in memory.  Chunking is skipped — one
    full pass — when a stage declares ``shardable=False`` or qid runs
    are non-contiguous, exactly mirroring ``resolve_n_shards``.
    Returns the number of chunks executed.
    """
    rec = rec if rec is not None else _Recorder()
    n = len(frame)
    if n == 0:
        return 0
    bounds = [(0, n)]
    if chunk_rows is not None and 0 < int(chunk_rows) < n:
        want = -(-n // int(chunk_rows))
        if all(node.shardable for node in graph.nodes
               if node.kind == "stage") \
                and ("qid" not in frame
                     or _qid_runs_unique(frame["qid"])):
            bounds = _shard_bounds(frame, want)
    for lo, hi in bounds:
        chunk = frame if (lo, hi) == (0, n) \
            else frame.take(np.arange(lo, hi))
        run_sequential(graph, chunk, batch_size, rec)
    return len(bounds)


def run_concurrent(graph: PlanGraph, frame: ColFrame,
                   batch_size: Optional[int], n_shards: int, workers: int,
                   rec: _Recorder) -> Tuple[List[ColFrame],
                                            List[Tuple[int, int]]]:
    """Sharded wavefront execution on a thread pool.

    Each (node, shard) pair is one task; a task becomes ready when its
    node's effective inputs have completed *for its shard*, so
    wavefronts advance independently per shard and independent branches
    of one shard run in parallel.  Python-level work holds the GIL, but
    IR stages dominated by I/O, BLAS or accelerator dispatch release it
    — those are exactly the stages worth sharding.

    Returns (per-pipeline merged outputs, shard bounds).
    """
    bounds = _shard_bounds(frame, n_shards)
    n_shards = len(bounds)
    pf = _Prefetcher.for_graph(graph)

    results: Dict[Tuple[int, int], ColFrame] = {}
    for s, (lo, hi) in enumerate(bounds):
        shard = frame.take(np.arange(lo, hi))
        results[(graph.source.id, s)] = shard
        if pf is not None:
            # per-shard query-keyed prefetch at submit time, before any
            # task is scheduled — the store reads overlap wave 0
            pf.node_ready(graph.source.id, shard)

    schedulable, children = _wave_edges(graph)
    indeg: Dict[Tuple[int, int], int] = {}
    for node in schedulable:
        for s in range(n_shards):
            indeg[(node.id, s)] = len(_effective_inputs(node))

    # ready tasks pop in critical-path order: the operand-order pass
    # stamps each node's sched_priority with its own estimated cost plus
    # the costliest downstream path, so when more tasks are ready than
    # workers the long pole starts first.  The monotone sequence number
    # keeps equal-priority tasks FIFO (and, with priorities all zero —
    # the cost-blind default — reduces to the previous deque order).
    ready: List[Tuple[float, int, IRNode, int]] = []
    seq = 0

    def complete(node_id: int, s: int) -> None:
        nonlocal seq
        for child in children.get(node_id, ()):
            key = (child.id, s)
            indeg[key] -= 1
            if indeg[key] == 0:
                heapq.heappush(ready,
                               (-child.sched_priority, seq, child, s))
                seq += 1

    for s in range(n_shards):
        complete(graph.source.id, s)

    def exec_task(node: IRNode, s: int) -> None:
        if node.probe_input is not None and node.cache is not None:
            out = _exec_with_probe(node, results[(node.probe_input.id, s)],
                                   batch_size, s, rec)
        else:
            ins = [results[(i.id, s)] for i in node.inputs]
            t0 = time.perf_counter()
            out = _exec_node(node, ins, batch_size)
            rec.add(node.label, s, t0, time.perf_counter())
        results[(node.id, s)] = out

    try:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures: Dict[Any, Tuple[IRNode, int]] = {}

            def submit_ready() -> None:
                while ready:
                    _, _, node, s = heapq.heappop(ready)
                    fut = pool.submit(exec_task, node, s)
                    futures[fut] = (node, s)

            submit_ready()
            while futures:
                done, _ = wait(set(futures), return_when=FIRST_COMPLETED)
                for fut in done:
                    node, s = futures.pop(fut)
                    fut.result()                 # propagate task errors
                    if pf is not None:
                        # doc-keyed consumers of this node start their
                        # store reads now, overlapping sibling branches
                        pf.node_ready(node.id, results[(node.id, s)])
                    complete(node.id, s)
                submit_ready()
    finally:
        if pf is not None:
            pf.close()

    outs = [ColFrame.concat([results[(t.id, s)] for s in range(n_shards)])
            for t in graph.terminals]
    return outs, bounds


# ---------------------------------------------------------------------------
# online / incremental mode — micro-batched streaming execution
# ---------------------------------------------------------------------------

class Reservoir:
    """Bounded, thread-safe reservoir sample of a float stream.

    Fixes the unbounded-growth failure mode of keeping every latency in
    a list: memory is capped at ``capacity`` floats while percentiles
    stay estimates of the *whole* stream (Algorithm R, deterministic
    RNG so repeated runs are reproducible)."""

    __slots__ = ("capacity", "count", "_buf", "_rng", "_lock")

    def __init__(self, capacity: int = 2048, seed: int = 0):
        self.capacity = max(1, int(capacity))
        self.count = 0
        self._buf: List[float] = []
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            self.count += 1
            if len(self._buf) < self.capacity:
                self._buf.append(float(value))
            else:
                j = self._rng.randrange(self.count)
                if j < self.capacity:
                    self._buf[j] = float(value)

    def extend(self, values: Sequence[float]) -> None:
        for v in values:
            self.add(v)

    def percentile(self, p: float) -> float:
        with self._lock:
            return float(np.percentile(self._buf, p)) if self._buf else 0.0

    @property
    def mean(self) -> float:
        with self._lock:
            return float(np.mean(self._buf)) if self._buf else 0.0

    @property
    def max(self) -> float:
        with self._lock:
            return float(np.max(self._buf)) if self._buf else 0.0

    def snapshot(self) -> List[float]:
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


class NodeOnlineStats:
    """Per-node accounting of the streaming executor: execution count,
    rows processed, and a bounded latency reservoir."""

    __slots__ = ("executions", "rows", "latency_ms", "_lock")

    def __init__(self) -> None:
        self.executions = 0
        self.rows = 0
        self.latency_ms = Reservoir(1024)
        self._lock = threading.Lock()

    def record(self, dt_ms: float, rows: int) -> None:
        with self._lock:
            self.executions += 1
            self.rows += int(rows)
        self.latency_ms.add(dt_ms)

    def as_dict(self) -> Dict[str, float]:
        return {"executions": self.executions, "rows": self.rows,
                "p50_ms": round(self.latency_ms.percentile(50), 4),
                "p99_ms": round(self.latency_ms.percentile(99), 4)}


class StreamStats:
    """Service-level accounting of the streaming executor: flush
    triggers, queue depth, micro-batch occupancy, per-node online
    latency, and cache hit/miss totals built from *per-call* counts."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.rows_in = 0                 # rows submitted (pre-coalesce)
        self.rows_executed = 0           # unique rows after coalescing
        self.flush_size = 0              # dispatches triggered by max_batch
        self.flush_timeout = 0           # ... by max_wait_ms
        self.flush_forced = 0            # ... by flush()/close()
        self.cache_hits = 0
        self.cache_misses = 0
        self.queue_depth = Reservoir(1024)
        self.batch_requests = Reservoir(1024)
        self.nodes: Dict[str, NodeOnlineStats] = {}

    def node(self, label: str) -> NodeOnlineStats:
        with self._lock:
            ns = self.nodes.get(label)
            if ns is None:
                ns = self.nodes[label] = NodeOnlineStats()
            return ns

    def record_batch(self, *, n_requests: int, rows_in: int,
                     rows_executed: int, cause: str) -> None:
        with self._lock:
            self.requests += n_requests
            self.batches += 1
            self.rows_in += rows_in
            self.rows_executed += rows_executed
            if cause == "size":
                self.flush_size += 1
            elif cause == "timeout":
                self.flush_timeout += 1
            else:
                self.flush_forced += 1
        self.batch_requests.add(n_requests)

    def add_cache_counts(self, hits: int, misses: int) -> None:
        if hits or misses:
            with self._lock:
                self.cache_hits += hits
                self.cache_misses += misses

    def occupancy(self, max_batch: int) -> float:
        """Mean micro-batch fill: requests per dispatch / ``max_batch``."""
        return self.batch_requests.mean / max(1, max_batch)

    def node_dicts(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            labels = list(self.nodes.items())
        return {label: ns.as_dict() for label, ns in labels}

    def as_dict(self, max_batch: Optional[int] = None) -> Dict[str, Any]:
        out = {
            "requests": self.requests, "batches": self.batches,
            "rows_in": self.rows_in, "rows_executed": self.rows_executed,
            "flush_size": self.flush_size,
            "flush_timeout": self.flush_timeout,
            "flush_forced": self.flush_forced,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "queue_depth_p50": round(self.queue_depth.percentile(50), 2),
            "queue_depth_p99": round(self.queue_depth.percentile(99), 2),
            "queue_depth_max": round(self.queue_depth.max, 2),
            "nodes": self.node_dicts(),
        }
        if max_batch is not None:
            out["batch_occupancy"] = round(self.occupancy(max_batch), 4)
        return out


def _freeze_value(v: Any) -> Any:
    """A hashable, reliably-comparable stand-in for a row value — row
    identity drives coalescing, and raw numpy arrays would make the
    tuple comparison raise ('truth value of an array is ambiguous')."""
    if isinstance(v, np.ndarray):
        return ("__ndarray__", v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_freeze_value(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze_value(x)) for k, x in v.items()))
    if isinstance(v, np.generic):
        return v.item()
    return v


class _StreamRequest:
    __slots__ = ("rows", "qid_rows", "qid_orig", "qid_order", "future",
                 "t0")

    def __init__(self, rows: List[Dict[str, Any]]):
        self.rows = rows
        # per-qid: a frozen content key (drives coalescing comparisons)
        # plus the ORIGINAL rows (what actually executes); first-seen
        # qid order preserved
        self.qid_rows: Dict[str, Tuple] = {}
        self.qid_orig: Dict[str, List[Dict[str, Any]]] = {}
        self.qid_order: List[str] = []
        for r in rows:
            q = str(r.get("qid"))
            frozen = tuple(sorted((k, _freeze_value(v))
                                  for k, v in r.items()))
            if q not in self.qid_rows:
                self.qid_rows[q] = (frozen,)
                self.qid_orig[q] = [r]
                self.qid_order.append(q)
            else:
                self.qid_rows[q] = self.qid_rows[q] + (frozen,)
                self.qid_orig[q].append(r)
        self.future: Future = Future()
        self.t0 = time.perf_counter()


class _BatchMeta:
    __slots__ = ("requests", "cause", "n_rows_in", "failed",
                 "hits", "misses")

    def __init__(self, requests: List[_StreamRequest], cause: str,
                 n_rows_in: int):
        self.requests = requests
        self.cause = cause
        self.n_rows_in = n_rows_in
        self.failed = False
        self.hits = 0
        self.misses = 0


_STOP = object()
_FLUSH = object()


class StreamingExecutor:
    """Incremental wavefront scheduler for online serving.

    Long-lived: a dispatcher thread drains a bounded request queue into
    micro-batches — a batch closes when ``max_batch`` requests are
    waiting, when ``max_wait_ms`` has elapsed since its first request,
    or on an explicit :meth:`flush`.  Requests in one batch are
    *coalesced* per qid (N in-flight requests sharing a query execute
    its rows once; every requester gets the result), the unique rows
    execute as ONE frame through the DAG, and the terminal output is
    demultiplexed back onto the request futures by qid.

    The wavefront machinery (``_wave_edges`` / instance-id addressing /
    probe-first cache-prune evaluation) is shared with the offline
    sharded scheduler: a micro-batch occupies the structural slot of a
    shard, so while batch *k* is in the reranker, batch *k+1* can
    already be in the retriever on the same thread pool.

    Correctness relies on the same row-local-per-qid contract as
    sharding (``Transformer.shardable``): when any stage declares
    ``shardable=False``, requests are NOT coalesced across submissions
    — each request executes as its own single-request batch.
    """

    def __init__(self, graph: PlanGraph, *, batch_size: Optional[int] = None,
                 max_batch: int = 32, max_wait_ms: float = 2.0,
                 max_workers: int = 4, queue_capacity: int = 1024,
                 on_batch: Optional[Callable[..., None]] = None):
        if len(graph.terminals) != 1:
            raise ValueError(
                f"StreamingExecutor serves exactly one pipeline; the plan "
                f"has {len(graph.terminals)} terminals")
        self.graph = graph
        self.terminal = graph.terminals[0]
        self._schedulable, self._children = _wave_edges(graph)
        self._prefetcher = _Prefetcher.for_graph(graph)
        self.coalescing = all(n.shardable for n in graph.nodes
                              if n.kind == "stage")
        self.batch_size = batch_size
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms) / 1000.0)
        self.stats = StreamStats()
        self._on_batch = on_batch
        self._queue: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max(1, int(queue_capacity)))
        # serializes enqueue against close(): nothing can land behind
        # the _STOP sentinel, so no future is ever left pending
        self._submit_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(max_workers)),
            thread_name_prefix="repro-torch-serve")
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._results: Dict[Tuple[int, int], ColFrame] = {}
        self._indeg: Dict[Tuple[int, int], int] = {}
        self._meta: Dict[int, _BatchMeta] = {}
        self._seq = 0
        self._inflight = 0
        self._closed = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="repro-torch-serve-dispatch",
            daemon=True)
        self._dispatcher.start()

    # -- client API ----------------------------------------------------------
    def submit(self, rows: List[Dict[str, Any]]) -> Future:
        """Enqueue one request (one or more query rows, each carrying a
        ``qid``).  Returns a future resolving to the pipeline output for
        those rows.  Blocks (backpressure) when the queue is full."""
        if not rows:
            fut: Future = Future()
            fut.set_result(ColFrame())
            return fut
        for r in rows:
            if "qid" not in r:
                raise ValueError("every request row needs a 'qid'")
        req = _StreamRequest([dict(r) for r in rows])
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("StreamingExecutor is closed")
            self._queue.put(req)
        self.stats.queue_depth.add(self._queue.qsize())
        return req.future

    def flush(self) -> None:
        """Dispatch whatever is queued without waiting for the batch
        window to fill or expire."""
        with self._submit_lock:
            if not self._closed:
                self._queue.put(_FLUSH)

    def close(self, timeout: float = 60.0) -> None:
        """Dispatch remaining requests, wait for in-flight batches, and
        shut the pool down."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_STOP)
        self._dispatcher.join(timeout=timeout)
        with self._idle:
            self._idle.wait_for(lambda: self._inflight == 0,
                                timeout=timeout)
        self._pool.shutdown(wait=True)
        if self._prefetcher is not None:
            self._prefetcher.close()

    def __enter__(self) -> "StreamingExecutor":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- dispatcher ----------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            if item is _FLUSH:
                continue
            batch: List[_StreamRequest] = [item]
            cause = "size"
            stop = False
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                try:
                    # window expired (or max_wait_ms=0): drain whatever
                    # is already queued without waiting, so backlogged
                    # submissions still coalesce into one batch
                    nxt = self._queue.get(timeout=remaining) \
                        if remaining > 0 else self._queue.get_nowait()
                except queue_mod.Empty:
                    cause = "timeout"
                    break
                if nxt is _STOP:
                    stop, cause = True, "forced"
                    break
                if nxt is _FLUSH:
                    cause = "forced"
                    break
                batch.append(nxt)
            try:
                self._launch(batch, cause)
            except BaseException as e:     # never kill the dispatcher
                for req in batch:
                    try:
                        req.future.set_exception(e)
                    except Exception:
                        pass
            if stop:
                return

    def _coalesce(self, batch: List[_StreamRequest]
                  ) -> List[Tuple[List[_StreamRequest],
                                  Dict[str, List[Dict[str, Any]]]]]:
        """Group a dispatch window into sub-batches whose qid → rows
        maps agree: requests sharing a qid with identical rows merge
        (the shared query executes once); a request re-using a qid with
        *different* rows starts a new sub-batch so per-qid semantics
        stay exact."""
        if not self.coalescing:
            return [([req], dict(req.qid_orig)) for req in batch]
        groups: List[Tuple[List[_StreamRequest],
                           Dict[str, List[Dict[str, Any]]]]] = []
        reqs: List[_StreamRequest] = []
        frozen: Dict[str, Tuple] = {}
        orig: Dict[str, List[Dict[str, Any]]] = {}
        for req in batch:
            conflict = any(frozen.get(q) is not None and frozen[q] != rows
                           for q, rows in req.qid_rows.items())
            if conflict and reqs:
                groups.append((reqs, orig))
                reqs, frozen, orig = [], {}, {}
            reqs.append(req)
            for q, rows in req.qid_rows.items():
                frozen.setdefault(q, rows)
                orig.setdefault(q, req.qid_orig[q])
        if reqs:
            groups.append((reqs, orig))
        return groups

    def _launch(self, batch: List[_StreamRequest], cause: str) -> None:
        # groups are isolated: one group failing to build or launch
        # fails only ITS requests — other groups of the window proceed
        for reqs, qid_rows in self._coalesce(batch):
            try:
                self._launch_group(reqs, qid_rows, cause)
            except BaseException as e:
                for req in reqs:
                    try:
                        req.future.set_exception(e)
                    except Exception:
                        pass

    def _launch_group(self, reqs: List[_StreamRequest],
                      qid_rows: Dict[str, List[Dict[str, Any]]],
                      cause: str) -> None:
        rows: List[Dict[str, Any]] = []
        for q in qid_rows:
            rows.extend(qid_rows[q])
        frame = ColFrame.from_dicts(rows)   # before any state mutation
        n_rows_in = sum(len(r.rows) for r in reqs)
        if self._prefetcher is not None:
            # query-keyed store reads start before the batch is even
            # scheduled — they overlap this batch's wave-0 compute (and
            # any other batch in flight)
            self._prefetcher.node_ready(self.graph.source.id, frame)
        with self._lock:
            s = self._seq
            self._seq += 1
            self._results[(self.graph.source.id, s)] = frame
            for node in self._schedulable:
                self._indeg[(node.id, s)] = len(_effective_inputs(node))
            self._meta[s] = _BatchMeta(reqs, cause, n_rows_in)
            self._inflight += 1
            ready = self._complete_locked(self.graph.source.id, s)
        self.stats.record_batch(n_requests=len(reqs), rows_in=n_rows_in,
                                rows_executed=len(frame), cause=cause)
        try:
            for node in ready:
                self._pool.submit(self._run_task, node, s)
        except BaseException as e:
            # pool refused (shutdown race): unwind _inflight and fail
            # this batch's futures so close() never stalls
            self._fail_batch(s, e)

    # -- wavefront -----------------------------------------------------------
    def _complete_locked(self, node_id: int, s: int) -> List[IRNode]:
        ready = []
        for child in self._children.get(node_id, ()):
            key = (child.id, s)
            if key not in self._indeg:
                continue                 # batch already failed/cleaned
            self._indeg[key] -= 1
            if self._indeg[key] == 0:
                ready.append(child)
        return ready

    def _run_task(self, node: IRNode, s: int) -> None:
        with self._lock:
            meta = self._meta.get(s)
        if meta is None or meta.failed:
            return
        cache = node.cache
        # hand-wrapped caches arrive as the *stage* (e.g. the legacy
        # scorer service pipeline `ScorerCache(scorer)`), planner memos
        # as node.cache — count per-call hits from whichever runs
        runner = cache if cache is not None else node.stage
        track = runner is not None and hasattr(runner, "pop_call_counts")
        if track:
            runner.pop_call_counts()     # drop stale counts on this thread
        try:
            t0 = time.perf_counter()
            if node.probe_input is not None and cache is not None:
                out = _exec_with_probe(
                    node, self._results[(node.probe_input.id, s)],
                    self.batch_size, s, _NULL_RECORDER)
            else:
                ins = [self._results[(i.id, s)] for i in node.inputs]
                out = _exec_node(node, ins, self.batch_size)
            dt_ms = (time.perf_counter() - t0) * 1000.0
        except BaseException as e:
            self._fail_batch(s, e)
            return
        hits = misses = 0
        if track:
            hits, misses = runner.pop_call_counts()
            self.stats.add_cache_counts(hits, misses)
        with self._lock:
            if s not in self._meta:      # batch failed & was cleaned up
                return
            self._results[(node.id, s)] = out
            meta.hits += hits
            meta.misses += misses
        if self._prefetcher is not None:
            # doc-keyed caches fed by this node (scorers after a
            # retriever) can start fetching for this batch now
            self._prefetcher.node_ready(node.id, out)
        self.stats.node(node.label).record(dt_ms, rows=len(out))
        if node is self.terminal:
            self._finalize(s, out)
            return
        with self._lock:
            ready = self._complete_locked(node.id, s)
        for child in ready:
            self._pool.submit(self._run_task, child, s)

    # -- completion ----------------------------------------------------------
    def _cleanup_locked(self, s: int) -> Optional[_BatchMeta]:
        meta = self._meta.pop(s, None)
        for k in [k for k in self._results if k[1] == s]:
            del self._results[k]
        for k in [k for k in self._indeg if k[1] == s]:
            del self._indeg[k]
        if meta is not None:
            self._inflight -= 1
            self._idle.notify_all()
        return meta

    def _finalize(self, s: int, out: ColFrame) -> None:
        with self._idle:
            meta = self._cleanup_locked(s)
        if meta is None:
            return
        groups = {str(k[0]): idx for k, idx in
                  out.group_indices(["qid"]).items()} if len(out) else {}
        now = time.perf_counter()
        latencies = []
        for req in meta.requests:
            parts = [out.take(groups[q]) for q in req.qid_order
                     if q in groups]
            res = parts[0] if len(parts) == 1 else (
                ColFrame.concat(parts) if parts else ColFrame())
            latencies.append((now - req.t0) * 1000.0)
            try:                         # a caller may have cancelled;
                req.future.set_result(res)   # never stall its batchmates
            except Exception:
                pass
        if self._on_batch is not None:
            try:
                self._on_batch(n_requests=len(meta.requests),
                               latencies_ms=latencies, cause=meta.cause,
                               cache_hits=meta.hits,
                               cache_misses=meta.misses)
            except Exception:
                pass

    def _fail_batch(self, s: int, err: BaseException) -> None:
        with self._idle:
            meta = self._cleanup_locked(s)
            if meta is not None:
                meta.failed = True
        if meta is None:
            return
        for req in meta.requests:
            try:
                req.future.set_exception(err)
            except Exception:            # already resolved/cancelled
                pass
