"""Physical executors for optimized plan graphs (``core/ir.py``).

Counterpart of the offline executors of ``repro.core.executor``: the
third layer of the plan compiler, schedulers that evaluate a
:class:`~repro_torch.core.ir.PlanGraph` over a query frame.  The two
have identical semantics:

* :func:`run_sequential` — recursive post-order evaluation, one node at
  a time, results memoized per node instance;
* :func:`run_concurrent` — the sharded wavefront scheduler: the query
  frame is partitioned into qid-aligned shards and (node, shard) tasks
  run on a thread pool as their per-shard inputs complete.

Both understand the ``cache-prune`` annotations of ``core/rewrite.py``:
a node with a ``probe_input`` is evaluated *lookup-first* — its memo
cache is probed with the deferred chain's input, and the chain
(``inline_chain``) only executes when the store cannot serve every key.
Deferred nodes are excluded from normal scheduling; they run inline
inside their consumer's task.

The reference's cache prefetcher and cache warming come with the
port's async data plane, its streaming executor with serving.

Scheduling invariants: every node runs **at most once per shard**
(results are memoized per node instance, never recomputed for a second
consumer); tasks are dispatched in **topological wavefronts**, so a
node's inputs are complete frames before it runs; and the query frame
is partitioned only along **qid-aligned boundaries** and only when
every stage in the graph is ``shardable`` (row-local per qid) — a
single non-shardable stage collapses execution to one shard, leaving
branch parallelism only.  Under these rules the sequential and
concurrent schedulers are observationally identical.
"""
from __future__ import annotations

import heapq
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .frame import ColFrame
from .ir import IRNode, PlanGraph
from .precompute import _run_stage

__all__ = ["run_sequential", "run_concurrent", "resolve_n_shards"]


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
    structure of the sharded scheduler.  Nodes are addressed by
    instance id throughout."""
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


def run_sequential(graph: PlanGraph, frame: ColFrame,
                   batch_size: Optional[int],
                   rec: Optional[_Recorder] = None) -> List[ColFrame]:
    """Evaluate all terminals over ``frame``; returns per-pipeline
    results.  Execution records accumulate into ``rec``."""
    rec = rec if rec is not None else _Recorder()
    results: Dict[int, ColFrame] = {graph.source.id: frame}

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
        return out

    return [evaluate(t) for t in graph.terminals]


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

    results: Dict[Tuple[int, int], ColFrame] = {}
    for s, (lo, hi) in enumerate(bounds):
        results[(graph.source.id, s)] = frame.take(np.arange(lo, hi))

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
                complete(node.id, s)
            submit_ready()

    outs = [ColFrame.concat([results[(t.id, s)] for s in range(n_shards)])
            for t in graph.terminals]
    return outs, bounds
