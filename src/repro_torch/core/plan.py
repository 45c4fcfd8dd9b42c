"""ExecutionPlan — façade over the plan compiler.

Counterpart of ``repro.core.plan``.  The paper develops two
complementary directions: *implicit* prefix sharing inside
``Experiment`` (§3 — the LCP of Eq. 2, generalized to a prefix trie for
the §6 ablation limitation) and *explicit* operation caches applied by
hand (§4).  ``ExecutionPlan`` unifies both behind a single abstraction,
following the "Trie-based Experiment Plans" follow-up, as a thin façade
over a three-layer compiler:

* **logical IR** (``core/ir.py``) — pipelines lower into a DAG forest,
  one node per operator occurrence, with relation types and
  ``shardable`` / ``rank_preserving`` / ``augment_only`` metadata
  lifted from ``Transformer``;
* **optimizer** (``core/rewrite.py``) — an ordered pass pipeline
  selected by ``optimize=``: algebraic normalization (commutative
  operands canonicalized), cross-pipeline CSE (identical subtrees
  *anywhere* in the DAG execute once — beyond prefixes, the §6
  resolution), ``RankCutoff`` pushdown into retriever ``num_results``
  through rank-preserving stages, and cache-aware pruning that consults
  the provenance manifests to defer work upstream of warm memo nodes;
* **physical executor** (``core/executor.py``) — the sequential and
  sharded-wavefront schedulers, semantics unchanged.

``optimize="all"`` (default) preserves the sharing behaviour of earlier
revisions; ``optimize="none"`` executes the naive forest (the paper's
baseline); a list of pass names runs exactly those passes in order.
The hard invariant is that optimizer-on and optimizer-off produce
bit-identical per-qid results under both schedulers.

Every plan node is fingerprinted (``node_fingerprints``) by the
provenance digest, the ``cachekey_hash`` kernel on the card, batched
one launch per (level, word length) group: the cost model, the node
cache manifests and the plan manifest key off these fingerprints.

``explain()`` renders the optimized plan as an ASCII tree (per-node
fingerprint, cache family, which pass touched it); the same record is
persisted in the plan manifest, in the reference's format.

The asynchronous data plane (``caching/dataplane.py``) is on by
default, as in the reference: planner-inserted caches prefetch their
warm-path reads on the I/O pool and buffer miss-path writes behind
(``prefetch=``, ``drain()``); ``warm()`` precomputes a plan's caches
offline.

``run_with_precompute``, ``run_with_trie`` and ``Experiment`` remain
thin wrappers over this module — the planner is the single execution
path.
"""
from __future__ import annotations

import hashlib
import inspect
import os
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from .cost import (CostContext, CostModel, annotate_node_actuals,
                   fold_costs, plan_fingerprints, should_prefetch,
                   _round_cost)
from . import trace
from .executor import (resolve_n_shards, run_concurrent, run_sequential,
                       run_warm)
from .frame import ColFrame
from .ir import IRNode, PlanGraph, lower, plan_size, render_explain
from .pipeline import Transformer, pipeline_hash
from .precompute import PrecomputeStats, longest_common_prefix
from .rewrite import (PLACEMENT_PASSES, POST_MEMO_PASSES, PassStats,
                      resolve_passes, run_pass)

__all__ = ["ExecutionPlan", "PlanNode", "PlanStats", "plan_size"]

#: backwards-compatible alias — plan nodes are IR nodes now
PlanNode = IRNode


@dataclass
class PlanStats(PrecomputeStats):
    """Per-run accounting of a plan execution."""
    nodes_planned: int = 0               # unique DAG nodes (excl. source)
    cache_hits: int = 0                  # memo hits across inserted caches
    cache_misses: int = 0
    #: subset of ``cache_hits`` served from the I/O-pool staging map
    #: (``caching/dataplane.py``) — attributed to the consuming node at
    #: consumption time, so hits+misses stay exactly the request count
    cache_prefetched: int = 0
    node_times_s: Dict[str, float] = field(default_factory=dict)
    node_exec_counts: Dict[str, int] = field(default_factory=dict)
    #: raw wrapped-transformer seconds (and the queries they covered)
    #: spent on cached nodes' miss paths this run — the recompute cost
    #: the fingerprint-keyed EWMA folds for cached nodes, since their
    #: ``node_times_s`` is dominated by store round trips (see
    #: ``caching.base.CacheStats.compute_s``)
    node_compute_s: Dict[str, float] = field(default_factory=dict)
    node_compute_queries: Dict[str, int] = field(default_factory=dict)
    wall_time_s: float = 0.0
    n_queries: int = 0                   # rows in the query frame
    #: seconds the plan's construction took (lowering, passes, opening
    #: caches): the ``plan.compile`` span
    compile_time_s: float = 0.0
    # -- online serving (filled by PipelineService, see serve/service.py) ----
    #: per-node online latency (p50/p99 ms), executions and rows, plus
    #: service-level queue depth / flush-trigger / batch-occupancy stats
    online: Dict[str, Any] = field(default_factory=dict)
    # -- optimizer ----------------------------------------------------------
    optimizer_passes: List[str] = field(default_factory=list)
    nodes_eliminated: int = 0            # removed by normalize+cse/pushdown
    cutoffs_pushed: int = 0              # RankCutoffs absorbed or moved
    nodes_pruned: int = 0                # warm-cache deferred nodes skipped
    pass_times_s: Dict[str, float] = field(default_factory=dict)
    # -- concurrent executor -------------------------------------------------
    n_shards: int = 1                    # query-frame partitions executed
    n_workers: int = 1                   # thread-pool size
    shard_times_s: List[float] = field(default_factory=list)
    occupancy: float = 0.0               # busy-time / (workers × wall)
    speedup_vs_sequential: Optional[float] = None  # filled by benchmarks

    def __str__(self) -> str:
        extra = ""
        if self.n_shards > 1 or self.n_workers > 1:
            extra = (f" shards={self.n_shards} workers={self.n_workers} "
                     f"occupancy={self.occupancy:.2f}")
        opt = ""
        if self.nodes_eliminated or self.cutoffs_pushed or self.nodes_pruned:
            opt = (f" eliminated={self.nodes_eliminated} "
                   f"pushed={self.cutoffs_pushed} "
                   f"pruned={self.nodes_pruned}")
        return (f"PlanStats(planned={self.nodes_planned} "
                f"executed={self.nodes_executed} "
                f"naive={self.nodes_total} "
                f"saved={self.stage_invocations_saved} "
                f"cache_hits={self.cache_hits} "
                f"wall={self.wall_time_s:.3f}s{opt}{extra})")


def _accepted_kwargs(factory: Callable[..., Any],
                     wanted: Dict[str, Any]) -> Dict[str, Any]:
    """The subset of ``wanted`` that ``factory`` can accept — custom
    memo factories keep their minimal ``(stage, path)`` signature while
    richer ones opt into ``backend`` / ``fingerprint`` / ``on_stale``."""
    try:
        params = inspect.signature(factory).parameters.values()
    except (TypeError, ValueError):      # builtins / C callables
        return {}
    if any(p.kind == p.VAR_KEYWORD for p in params):
        return dict(wanted)
    names = {p.name for p in params
             if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    return {k: v for k, v in wanted.items() if k in names}


class ExecutionPlan:
    """Lower a pipeline set into a shared DAG, optimize it, execute it.

    Parameters
    ----------
    pipelines:
        The systems of an experiment (operator-algebra expressions).
    cache_dir:
        When given, enables planner-inserted memoization: each eligible
        node gets an explicit cache (selected by ``auto_cache`` from the
        node's metadata) rooted under this directory, so repeated runs —
        or overlapping plans pointed at the same directory — hit.
    cache_backend:
        Storage backend for planner-inserted caches, by registry name
        (``"memory"`` / ``"pickle"`` / ``"dbm"`` / ``"sqlite"`` — see
        ``caching/backends.py``).  ``None`` keeps each cache family's
        default.  ``cache_backend="memory"`` alone (no ``cache_dir``)
        enables purely in-process memoization.
    memo_factory:
        Pluggable cache policy ``(transformer, path, **kw) -> wrapper |
        None``.  Defaults to ``repro_torch.caching.auto.auto_cache_or_none``
        with uncacheable stages (per §5, e.g. DuoT5-style scorers) left
        bare.  Factories that accept them also receive ``fingerprint=``
        (the node's provenance fingerprint) and ``on_stale=``.
    on_stale:
        Policy when a node's cache directory records a different
        provenance fingerprint (``caching/provenance.py``): ``"error"``
        (default — raise ``StaleCacheError``), ``"recompute"`` (discard
        the stale entries) or ``"readonly"`` (serve them, never write).
    cache_budget:
        Optional per-node size/TTL envelope for planner-inserted caches
        (``caching/economics.py``: a ``CacheBudget``, a dict of
        ``max_entries``/``max_bytes``/``ttl_seconds``, or a bare int
        entry budget).  Recorded in each node directory's manifest and
        enforced on ``close()`` / by ``caching.economics.enforce_dir``.
    optimize:
        ``"all"`` (default) runs the full pass pipeline of
        ``core/rewrite.py``; ``"none"`` executes the naive lowered
        forest; a list of pass names (drawn from
        ``repro_torch.core.rewrite.OPTIMIZER_PASSES``) runs exactly
        those, in the given order.
    prefetch:
        Asynchronous data plane (``caching/dataplane.py``): when True
        (default), planner-inserted caches on prefetchable backends are
        stamped so the executors issue their warm-path store reads on a
        background I/O pool as soon as each node's input frame exists,
        overlapping compute; miss-path writes move to a bounded
        write-behind queue flushed on ``close()``/``drain()``.  Results
        are per-qid bit-identical with and without it; gated per node
        by :func:`repro_torch.core.cost.should_prefetch` and globally by
        ``REPRO_PREFETCH=0`` / ``REPRO_WRITE_BEHIND=0``.
    """

    def __init__(self, pipelines: Sequence[Transformer], *,
                 cache_dir: Optional[str] = None,
                 cache_backend: Optional[str] = None,
                 memo_factory: Optional[Callable[..., Any]] = None,
                 on_stale: str = "error",
                 cache_budget: Any = None,
                 optimize: Union[str, Sequence[str], None] = "all",
                 prefetch: bool = True):
        t0 = time.perf_counter_ns()
        self.pipelines: List[Transformer] = list(pipelines)
        self.cache_dir = cache_dir
        self.cache_backend = cache_backend
        self.cache_budget = cache_budget
        self._memo_factory = memo_factory
        self.on_stale = on_stale
        self.optimize = optimize
        self.prefetch = bool(prefetch)
        passes = resolve_passes(optimize)

        # -- layer 1: lowering ---------------------------------------------
        self.graph: PlanGraph = lower(self.pipelines)
        self.nodes_total_naive = sum(plan_size(p) for p in self.pipelines)

        self._node_fps: Optional[Dict[int, str]] = None
        self._plan_id: Optional[str] = None
        self._plan_manifest_path: Optional[str] = None

        # -- layer 2: optimizer (structural pre-memo passes) ---------------
        pre = [name for name in passes
               if name not in POST_MEMO_PASSES
               and name not in PLACEMENT_PASSES and name != "operand-order"]
        self.pass_stats: List[PassStats] = [
            run_pass(self.graph, name) for name in pre]
        if "cse" in pre and any(p.name == "pushdown" and p.cutoffs_pushed
                                for p in self.pass_stats):
            # pushdown can make previously distinct subtrees structurally
            # identical (e.g. `r % 3` fused next to a literal `r(n=3)`);
            # one more normalize+cse round merges them so the "any
            # identical subtree executes once" invariant holds
            self.pass_stats += [run_pass(self.graph, name)
                                for name in ("normalize", "cse")
                                if name in pre]
        # the cost-aware ordering pass runs last of the pre-memo passes,
        # after the re-round, so it orders the final structural DAG
        if "operand-order" in passes:
            self._ensure_cost_ctx()
            self.pass_stats.append(run_pass(self.graph, "operand-order"))

        if (cache_dir is not None or memo_factory is not None
                or cache_backend is not None):
            # cache placement must decide *before* memos are opened
            if "cache-place" in passes:
                self._ensure_cost_ctx()
                self.pass_stats.append(run_pass(self.graph, "cache-place"))
            self._insert_memos()
            # post-memo passes consult the freshly opened cache manifests
            # (cache-prune) and the manifest's run history (autotune)
            post = [name for name in passes if name in POST_MEMO_PASSES]
            if "autotune" in post:
                self._ensure_cost_ctx()
            self.pass_stats += [run_pass(self.graph, name) for name in post]
        self._label_nodes()
        # the self-describing record is built lazily — fingerprinting
        # every node is only worth paying for when something consumes it
        # (explain(), to_record(), or a plan manifest)
        self._record: Optional[Dict[str, Any]] = None
        if cache_dir is not None:
            self._write_plan_manifest()
        self.stats: Optional[PlanStats] = None   # last run
        t1 = time.perf_counter_ns()
        self.compile_time_s = (t1 - t0) * 1e-9
        trace.add("plan.compile", t0, t1)

    # -- compatibility views ------------------------------------------------
    @property
    def source(self) -> IRNode:
        return self.graph.source

    @property
    def terminals(self) -> List[IRNode]:
        return self.graph.terminals

    @property
    def nodes(self) -> Dict[Tuple, IRNode]:
        """Key-addressed node view.  After CSE keys are unique; under
        ``optimize="none"`` duplicate subtrees collapse in this *view*
        only (the executor addresses nodes by instance)."""
        out: Dict[Tuple, IRNode] = {}
        for node in self.graph.nodes:
            out.setdefault(node.key, node)
        return out

    def _label_nodes(self) -> None:
        """Unique display labels: the same stage planned under two
        different prefixes is two nodes and must not share a
        ``node_times_s`` entry."""
        seen: Dict[str, int] = {}
        for node in self.graph.nodes:
            if node.kind == "source":
                node.label = "<source>"
                continue
            base = repr(node.stage)
            k = seen.get(base, 0)
            seen[base] = k + 1
            node.label = base if k == 0 else f"{base}#{k}"

    # -- provenance --------------------------------------------------------
    def node_fingerprints(self) -> Dict[int, str]:
        """Provenance fingerprint per plan node (id-keyed): the stage's
        transformer fingerprint folded over the fingerprints of its
        input nodes, so a config/code change anywhere upstream changes
        every downstream node's fingerprint (``caching/provenance.py``).
        Commutative combine operands fold in sorted order, so the
        fingerprints — and everything keyed on them: cache provenance,
        measured costs — are invariant under the ``operand-order``
        rewrite.  Deterministic across processes, and digest for digest
        the reference's."""
        if self._node_fps is None:
            self._node_fps, self._plan_id = plan_fingerprints(self.graph)
        return self._node_fps

    # -- cost layer --------------------------------------------------------
    def _ensure_cost_ctx(self) -> None:
        """Attach a :class:`~repro_torch.core.cost.CostContext` as
        ``graph.cost`` (once): the measured-cost EWMA table and run
        history from the prior plan manifest, plus the microbenchmarked
        cache round-trip of the resolved backend when this plan will
        insert caches.  Consumed by the ``operand-order`` /
        ``cache-place`` / ``autotune`` passes."""
        if self.graph.cost is not None:
            return
        fps = self.node_fingerprints()
        record: Optional[Dict[str, Any]] = None
        history: List[Dict[str, Any]] = []
        if self.cache_dir is not None:
            prior = os.path.join(self.cache_dir, "plans",
                                 f"{self._plan_id}.json")
            if os.path.exists(prior):
                try:
                    import json
                    with open(prior, "r", encoding="utf-8") as f:
                        record = json.load(f)
                    history = [r for r in record.get("runs", [])
                               if isinstance(r, dict)]
                except Exception:
                    record = None
        backend = round_trip = None
        if (self.cache_dir is not None or self.cache_backend is not None
                or self._memo_factory is not None):
            from ..caching.backends import (measure_round_trip,
                                            resolve_backend_name)
            try:
                # with no explicit selector each cache family picks its
                # own default, so there is no single name to promote —
                # ctx.backend stays None (cache-place still *skips* using
                # the measured round trip of a representative store)
                resolved = resolve_backend_name(self.cache_backend,
                                                default="sqlite")
                round_trip = measure_round_trip(resolved)
                if self.cache_backend is not None:
                    backend = resolved
            except Exception:
                backend = round_trip = None
        self.graph.cost = CostContext(
            model=CostModel.from_manifest(record), fps=fps,
            backend=backend, round_trip_s=round_trip, history=history)

    def tuning(self) -> Dict[str, Any]:
        """Knob values chosen by the ``autotune`` pass (``n_shards``,
        ``max_batch``, ``max_wait_ms`` — whichever had evidence), flat
        ``{knob: value}``.  ``serve`` consumes these via
        ``max_batch="auto"``; offline callers can forward ``n_shards``
        to :meth:`run`.  Empty when autotune did not run or had no
        evidence."""
        return {k: v.get("value") for k, v in self.graph.tuning.items()
                if isinstance(v, dict)}

    # -- planner-inserted memoization --------------------------------------
    def _insert_memos(self) -> None:
        factory = self._memo_factory
        if factory is None:
            from ..caching.auto import auto_cache_or_none
            factory = auto_cache_or_none
        kwargs: Dict[str, Any] = {}
        if self.cache_backend is not None:
            kwargs["backend"] = self.cache_backend
        if self.cache_budget is not None:
            kwargs["budget"] = self.cache_budget
        fps = self.node_fingerprints()
        for node in self.graph.nodes:
            if node.kind != "stage":
                continue
            if node.cache_skip:
                continue                 # cache-place: recompute is cheaper
            path = None
            if self.cache_dir is not None:
                # key the store by the node's full structural position so
                # the same stage under different prefixes never collides;
                # sha256 (not hash()) so the path is stable across
                # processes; the commutative-canonical key (when the
                # normalize pass ran) so it is stable under operand-order
                # swaps — a reorder must never cool a warm cache
                basis = node.canon_key if node.canon_key is not None \
                    else node.key
                digest = hashlib.sha256(
                    repr(basis).encode()).hexdigest()[:16]
                path = os.path.join(
                    self.cache_dir, pipeline_hash(node.stage) + "-" + digest)
            wanted = {**kwargs, "fingerprint": fps[node.id],
                      "on_stale": self.on_stale,
                      # planner-inserted caches opt into write-behind:
                      # the plan's close()/collect path drains them, and
                      # relaxing cross-process puts from exactly-once to
                      # at-least-once-with-identical-results is safe for
                      # deterministic transformers (hand-wrapped caches
                      # keep synchronous puts unless asked)
                      "async_writes": True}
            if node.backend_override is not None:
                wanted["backend"] = node.backend_override
            node.cache = factory(node.stage, path,
                                 **_accepted_kwargs(factory, wanted))
        self._stamp_prefetch()

    def _stamp_prefetch(self) -> None:
        """Mark which memoized nodes the executors should prefetch:
        plan opt-in (``prefetch=``), a global kill switch
        (``REPRO_PREFETCH=0``), the backend's ``prefetchable`` flag
        (memory-speed tiers decline), and the cost gate
        (:func:`~repro_torch.core.cost.should_prefetch` on the measured
        store round trip).  Purely a scheduling decision — results are
        identical either way."""
        from ..caching.dataplane import prefetch_default
        if not (self.prefetch and prefetch_default()):
            return
        cost = self.graph.cost
        round_trip = cost.round_trip_s if cost is not None else None
        if not should_prefetch(round_trip):
            return
        for node in self.graph.nodes:
            cache = node.cache
            if cache is None or not getattr(cache, "prefetchable", False):
                continue
            node.prefetch = True

    # -- explain / manifests ------------------------------------------------
    def _build_record(self) -> Dict[str, Any]:
        """The plan's self-describing record: structure, provenance,
        optimizer accounting.  Written to the plan manifest and rendered
        by ``explain()`` (the reference's ``repro plan explain`` reads the
        same format)."""
        from ..caching.provenance import PLAN_MANIFEST_VERSION
        fps = self.node_fingerprints()
        plan_id = self._plan_id      # the fingerprints' last level
        nodes = []
        for node in self.graph.nodes:
            if node.kind == "source":
                continue                 # rendered implicitly as <source>
            cache = node.cache
            # custom memo factories may return wrappers without a .path
            cache_path = getattr(cache, "path", None)
            nodes.append({
                "id": node.id,
                "label": node.label,
                "kind": node.kind,
                "relation": node.relation,
                "fingerprint": fps[node.id],
                "dir": os.path.basename(cache_path)
                       if cache_path is not None else None,
                "family": type(cache).__name__ if cache is not None else None,
                "inputs": [i.id for i in node.inputs],
                "touched_by": list(node.touched_by),
                "inlined": node.inlined,
                "probe_input": node.probe_input.id
                               if node.probe_input is not None else None,
                "cost_est_s": _round_cost(node.cost_est_s)
                              if node.cost_est_s is not None else None,
                "cost_src": node.cost_src,
                "cache_skip": node.cache_skip,
            })
        agg = self._aggregate_pass_stats()
        return {
            "format_version": PLAN_MANIFEST_VERSION,
            "plan_id": plan_id,
            "created_at": time.time(),
            "pipelines": [repr(p) for p in self.pipelines],
            "cache_backend": self.cache_backend,
            "on_stale": self.on_stale,
            "terminals": [t.id for t in self.graph.terminals],
            "nodes": nodes,
            "optimizer": {
                "passes": [p.name for p in self.pass_stats],
                "nodes_eliminated": agg["nodes_eliminated"],
                "cutoffs_pushed": agg["cutoffs_pushed"],
                "nodes_marked_prunable": agg["nodes_marked_prunable"],
                "caches_skipped": agg["caches_skipped"],
                "caches_promoted": agg["caches_promoted"],
                "inputs_reordered": agg["inputs_reordered"],
                "pass_stats": [p.as_dict() for p in self.pass_stats],
            },
            "tuning": dict(self.graph.tuning),
            "runs": [],
        }

    def _aggregate_pass_stats(self) -> Dict[str, int]:
        return {
            "nodes_eliminated": sum(p.nodes_eliminated
                                    for p in self.pass_stats),
            "cutoffs_pushed": sum(p.cutoffs_pushed for p in self.pass_stats),
            "nodes_marked_prunable": sum(p.nodes_marked_prunable
                                         for p in self.pass_stats),
            "caches_skipped": sum(p.caches_skipped for p in self.pass_stats),
            "caches_promoted": sum(p.caches_promoted
                                   for p in self.pass_stats),
            "inputs_reordered": sum(p.inputs_reordered
                                    for p in self.pass_stats),
        }

    def explain(self) -> str:
        """ASCII rendering of the optimized plan: one tree per pipeline
        with per-node id, relation, provenance fingerprint, cache family,
        the optimizer passes that touched the node and — when the cost
        layer ran — estimated-vs-actual per-query cost columns
        (``cost[est=… act=… src=…]``).  With a ``cache_dir`` the actuals
        come from the plan manifest's persisted EWMA table."""
        record = self.to_record()
        if self._plan_manifest_path is None and self.stats is not None \
                and self.stats.node_times_s:
            # no manifest to carry measured costs (in-memory plan):
            # overlay this run's actuals so explain() still shows them
            import copy
            record = copy.deepcopy(record)
            fold_costs(record, self.stats)
        return render_explain(record)

    def to_record(self) -> Dict[str, Any]:
        """The plan-manifest record (see ``_build_record``), built on
        first use."""
        if self._record is None:
            self._record = self._build_record()
        return self._record

    def _write_plan_manifest(self) -> None:
        """Record this plan in ``<cache_dir>/plans/<plan_id>.json`` so the
        cache directory is self-describing: which pipelines used it,
        which node dirs belong to which DAG position, with what
        provenance (the reference's ``repro cache`` and ``repro plan``
        CLIs read the same format)."""
        from ..caching.provenance import save_plan_manifest
        record = self.to_record()
        # re-planning the same pipeline set keeps its recorded history
        prior = os.path.join(self.cache_dir, "plans",
                             f"{record['plan_id']}.json")
        if os.path.exists(prior):
            try:
                import json
                with open(prior, "r", encoding="utf-8") as f:
                    old = json.load(f)
                record["created_at"] = old.get("created_at",
                                               record["created_at"])
                record["runs"] = list(old.get("runs", []))
                # measured per-node costs survive re-planning: they are
                # fingerprint-keyed, so stale entries simply never match
                record["costs"] = dict(old.get("costs") or {})
                annotate_node_actuals(record)
            except Exception:
                pass
        self._plan_manifest_path = save_plan_manifest(self.cache_dir, record)

    def _record_run(self, stats: PlanStats) -> None:
        """Append one run record to the plan manifest (best-effort)."""
        if self._plan_manifest_path is None:
            return
        try:
            import json
            with open(self._plan_manifest_path, "r", encoding="utf-8") as f:
                record = json.load(f)
            runs = record.setdefault("runs", [])
            run: Dict[str, Any] = {
                "at": time.time(),
                "nodes_executed": stats.nodes_executed,
                "nodes_pruned": stats.nodes_pruned,
                "cache_hits": stats.cache_hits,
                "cache_misses": stats.cache_misses,
                "cache_prefetched": stats.cache_prefetched,
                "n_shards": stats.n_shards,
                "n_workers": stats.n_workers,
                "wall_time_s": round(stats.wall_time_s, 4),
                "n_queries": stats.n_queries,
            }
            online = stats.online or {}
            if online:
                run["online"] = {k: online[k] for k in (
                    "batch_occupancy", "queue_depth_p50", "queue_depth_p99",
                    "max_batch", "max_wait_ms") if k in online}
            runs.append(run)
            del runs[:-50]               # keep the tail bounded
            # fold this run's measured per-node times into the
            # fingerprint-keyed EWMA cost table (core/cost.py) — the
            # next compile's cost model reads it back
            fold_costs(record, stats)
            if self._record is not None:
                # keep the in-memory record (explain()) in sync with the
                # persisted EWMA so both render identical actual columns
                self._record["costs"] = record.get("costs", {})
                annotate_node_actuals(self._record)
            from ..caching.backends import atomic_write_bytes
            atomic_write_bytes(
                self._plan_manifest_path,
                json.dumps(record, indent=2, sort_keys=True).encode("utf-8"))
        except Exception:
            pass

    def close(self) -> None:
        """Close planner-inserted caches (flushes temporary stores,
        write-behind queues, access sidecars and manifests, and enforces
        budgets)."""
        for node in self.graph.nodes:
            if node.cache is not None and hasattr(node.cache, "close"):
                node.cache.close()

    def drain(self) -> None:
        """Make planner-inserted caches durable without closing them:
        flush each family's write-behind queue and access log
        (``caching/dataplane.py``).  A crash after ``drain()`` returns
        loses nothing; a crash before it recomputes pending entries."""
        for node in self.graph.nodes:
            if node.cache is not None and hasattr(node.cache, "drain"):
                node.cache.drain()

    def __enter__(self) -> "ExecutionPlan":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- analysis ----------------------------------------------------------
    def n_nodes(self) -> int:
        return self.graph.n_nodes()

    # -- execution ---------------------------------------------------------
    def run(self, queries: Any, *, batch_size: Optional[int] = None,
            n_shards: Optional[int] = None,
            max_workers: Optional[int] = None,
            ) -> Tuple[List[ColFrame], PlanStats]:
        """Execute the DAG once over ``queries``.

        Every node runs at most once per shard; results are identical to
        naive per-pipeline execution (the cache-transparency invariant).

        ``n_shards`` / ``max_workers`` enable the concurrent executor:
        the query frame is partitioned into qid-aligned shards and
        (node, shard) tasks are scheduled in topological wavefronts on a
        thread pool.  With ``max_workers > 1`` and ``n_shards`` unset,
        the shard count defaults to ``ceil(len(queries)/batch_size)``
        when ``batch_size`` is given, else to ``max_workers``.  The
        default (both unset) is the sequential executor.

        Sharding assumes stages are row-local per qid (a qid group's
        output depends only on that group's rows) — the same contract
        ``batch_size`` already imposes.  Stages computing cross-query
        statistics must declare ``shardable=False``; the executor then
        falls back to one shard (branch parallelism still applies).
        """
        t0 = time.perf_counter()
        frame = ColFrame.coerce(queries)
        shards = resolve_n_shards(self.graph, frame, batch_size, n_shards,
                                  max_workers)
        if max_workers is not None:
            workers = max(1, int(max_workers))
        else:
            workers = min(32, shards) if shards > 1 else 1
        cache_base = self._cache_counters()
        compute_base = self._compute_counters()
        stats = self._new_stats()
        stats.n_queries = len(frame)
        rec = trace.Recorder()
        if shards <= 1 and workers <= 1:
            outs = run_sequential(self.graph, frame, batch_size, rec)
        else:
            outs, bounds = run_concurrent(self.graph, frame, batch_size,
                                          shards, workers, rec)
            stats.n_shards = len(bounds)
            stats.n_workers = workers
        self._fill_exec_stats(stats, rec)
        self._fill_compute_stats(stats, compute_base)
        self._finalize_stats(stats, cache_base, t0)
        if stats.n_shards > 1 or stats.n_workers > 1:
            busy = sum(b - a for _, _, a, b in rec.records)
            stats.occupancy = busy / (workers * stats.wall_time_s) \
                if stats.wall_time_s > 0 else 0.0
        return outs, stats

    def warm(self, queries: Any, *, batch_size: Optional[int] = None,
             chunk_rows: Optional[int] = None) -> PlanStats:
        """Speculative precomputation: execute the DAG over ``queries``
        purely to populate the planner-inserted caches, discarding the
        outputs (the paper's precomputation idea as an offline tool —
        ``caching.warming.warm_scenario`` drives this).

        The query frame is processed in qid-aligned chunks of at most
        ``chunk_rows`` rows (default: one chunk), so arbitrarily large
        warming logs run in bounded memory; chunking reuses the offline
        scheduler's shard machinery, so results in the caches are
        identical to a single full run.  Returns the usual
        :class:`PlanStats` (``cache_misses`` counts entries actually
        precomputed; a second warm over the same frame is all hits).
        """
        t0 = time.perf_counter()
        frame = ColFrame.coerce(queries)
        cache_base = self._cache_counters()
        compute_base = self._compute_counters()
        stats = self._new_stats()
        stats.n_queries = len(frame)
        rec = trace.Recorder()
        run_warm(self.graph, frame, batch_size, chunk_rows=chunk_rows,
                 rec=rec)
        self._fill_exec_stats(stats, rec)
        self._fill_compute_stats(stats, compute_base)
        self._finalize_stats(stats, cache_base, t0)
        return stats

    def _new_stats(self) -> PlanStats:
        agg = self._aggregate_pass_stats()
        return PlanStats(
            prefix_len=len(longest_common_prefix(self.pipelines)),
            n_pipelines=len(self.pipelines),
            nodes_total=self.nodes_total_naive,
            nodes_planned=self.n_nodes(),
            optimizer_passes=[p.name for p in self.pass_stats],
            compile_time_s=self.compile_time_s,
            nodes_eliminated=agg["nodes_eliminated"],
            cutoffs_pushed=agg["cutoffs_pushed"],
            pass_times_s=self._pass_times())

    def _pass_times(self) -> Dict[str, float]:
        """Per-pass wall time, summed over repeated rounds of a pass."""
        times: Dict[str, float] = {}
        for p in self.pass_stats:
            times[p.name] = round(times.get(p.name, 0.0) + p.time_s, 6)
        return times

    def _fill_exec_stats(self, stats: PlanStats,
                         rec: trace.Recorder) -> None:
        executed = set()
        for label, s, a, b in rec.records:
            executed.add(label)
            stats.node_times_s[label] = \
                stats.node_times_s.get(label, 0.0) + (b - a)
            stats.node_exec_counts[label] = \
                stats.node_exec_counts.get(label, 0) + 1
        stats.nodes_executed = len(executed)
        # deferred (cache-prune) nodes whose chain never ran this run
        stats.nodes_pruned = sum(
            1 for n in self.graph.nodes
            if n.inlined and n.label not in executed)
        if stats.n_shards > 1:
            for s in range(stats.n_shards):
                spans = [(a, b) for _, sh, a, b in rec.records if sh == s]
                stats.shard_times_s.append(
                    max(b for _, b in spans) - min(a for a, _ in spans)
                    if spans else 0.0)

    def _finalize_stats(self, stats: PlanStats,
                        cache_base: Tuple[int, int, int], t0: float) -> None:
        stats.stage_invocations_saved = \
            stats.nodes_total - stats.nodes_executed
        hits, misses, prefetched = self._cache_counters()
        stats.cache_hits = hits - cache_base[0]
        stats.cache_misses = misses - cache_base[1]
        stats.cache_prefetched = prefetched - cache_base[2]
        stats.wall_time_s = time.perf_counter() - t0
        if stats.n_shards > 1 and stats.wall_time_s > 0 \
                and stats.shard_times_s \
                and stats.speedup_vs_sequential is None:
            # sum of per-shard busy spans ≈ the sequential wall this run
            # would have taken; benchmarks overwrite with a measured ratio
            stats.speedup_vs_sequential = round(
                sum(stats.shard_times_s) / stats.wall_time_s, 2)
        self.stats = stats
        self._record_run(stats)

    def _cache_counters(self) -> Tuple[int, int, int]:
        hits = misses = prefetched = 0
        for node in self.graph.nodes:
            cs = getattr(node.cache, "stats", None)
            if cs is not None:
                hits += cs.hits
                misses += cs.misses
                prefetched += getattr(cs, "prefetched", 0)
        return hits, misses, prefetched

    def _compute_counters(self) -> Dict[str, Tuple[float, int]]:
        """Cumulative raw-compute counters per *cached* node label (see
        ``CacheStats.compute_s``) — snapshot before a run, delta after."""
        out: Dict[str, Tuple[float, int]] = {}
        for node in self.graph.nodes:
            cs = getattr(node.cache, "stats", None)
            if cs is not None and node.label is not None:
                out[node.label] = (float(getattr(cs, "compute_s", 0.0)),
                                   int(getattr(cs, "compute_queries", 0)))
        return out

    def _fill_compute_stats(self, stats: PlanStats,
                            base: Dict[str, Tuple[float, int]]) -> None:
        for label, (s1, q1) in self._compute_counters().items():
            s0, q0 = base.get(label, (0.0, 0))
            stats.node_compute_s[label] = s1 - s0
            stats.node_compute_queries[label] = q1 - q0
