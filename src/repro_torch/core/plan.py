"""ExecutionPlan — façade over the plan compiler.

Counterpart of ``repro.core.plan``.  The paper develops two
complementary directions: *implicit* prefix sharing inside
``Experiment`` (§3 — the LCP of Eq. 2, generalized to a prefix trie for
the §6 ablation limitation) and *explicit* operation caches applied by
hand (§4).  ``ExecutionPlan`` runs the first through a three-layer
compiler:

* **logical IR** (``core/ir.py``) — pipelines lower into a DAG forest,
  one node per operator occurrence, with relation types and
  ``shardable`` / ``rank_preserving`` / ``augment_only`` metadata
  lifted from ``Transformer``;
* **optimizer** (``core/rewrite.py``) — an ordered pass pipeline
  selected by ``optimize=``: algebraic normalization (commutative
  operands canonicalized), cross-pipeline CSE (identical subtrees
  *anywhere* in the DAG execute once — beyond prefixes, the §6
  resolution), ``RankCutoff`` pushdown into retriever ``num_results``
  through rank-preserving stages, and cost-aware operand ordering;
* **physical executor** (``core/executor.py``) — the sequential and
  sharded-wavefront schedulers.

``optimize="all"`` (default) shares every identical subtree;
``optimize="none"`` executes the naive forest (the paper's baseline); a
list of pass names runs exactly those passes in order.  Optimizer-on
and optimizer-off produce bit-identical per-qid results under both
schedulers.

Every plan node is fingerprinted (``node_fingerprints``) by the
provenance digest, the ``cachekey_hash`` kernel on the card: the
``operand-order`` pass keys its cost model by node fingerprint.

``explain()`` renders the optimized plan as an ASCII tree (per-node
fingerprint, which pass touched it, cost estimates).

Planner-inserted caches (``cache_dir=``, ``cache_backend=``,
``memo_factory=``) and their passes come with a later slice of the
port and raise ``NotImplementedError`` here; a hand-wrapped cache
(``ScorerCache(path, mono)``) inside a pipeline runs like any stage.

``run_with_precompute``, ``run_with_trie`` and ``Experiment`` remain
thin wrappers over this module — the planner is the single execution
path.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from .cost import CostContext, CostModel, plan_fingerprints, \
    fold_costs, _round_cost
from .executor import _Recorder, resolve_n_shards, run_concurrent, \
    run_sequential
from .frame import ColFrame
from .ir import IRNode, PlanGraph, lower, plan_size, render_explain
from .pipeline import Transformer
from .precompute import PrecomputeStats, longest_common_prefix
from .rewrite import PLACEMENT_PASSES, POST_MEMO_PASSES, PassStats, \
    resolve_passes, run_pass

__all__ = ["ExecutionPlan", "PlanNode", "PlanStats", "plan_size"]

#: backwards-compatible alias — plan nodes are IR nodes now
PlanNode = IRNode


@dataclass
class PlanStats(PrecomputeStats):
    """Per-run accounting of a plan execution — the reference's fields;
    those of planner-inserted caches, their cost channel and online
    serving stay at their defaults until the port has them."""
    nodes_planned: int = 0               # unique DAG nodes (excl. source)
    cache_hits: int = 0                  # memo hits across inserted caches
    cache_misses: int = 0
    cache_prefetched: int = 0            # hits served by prefetch
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
    # -- online serving ------------------------------------------------------
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


class ExecutionPlan:
    """Lower a pipeline set into a shared DAG, optimize it, execute it.

    Parameters
    ----------
    pipelines:
        The systems of an experiment (operator-algebra expressions).
    cache_dir, cache_backend, memo_factory:
        Planner-inserted memoization; not ported yet — anything but
        ``None`` raises ``NotImplementedError``.
    optimize:
        ``"all"`` (default) runs the reference's full pass list (the
        cache passes among it need planner-inserted caches and do not
        run without them); ``"none"`` executes the naive lowered forest;
        a list of pass names (drawn from
        ``repro_torch.core.rewrite.OPTIMIZER_PASSES``) runs exactly
        those, in the given order.
    """

    def __init__(self, pipelines: Sequence[Transformer], *,
                 cache_dir: Optional[str] = None,
                 cache_backend: Optional[str] = None,
                 memo_factory: Optional[Callable[..., Any]] = None,
                 optimize: Union[str, Sequence[str], None] = "all"):
        if (cache_dir is not None or cache_backend is not None
                or memo_factory is not None):
            raise NotImplementedError(
                "ExecutionPlan(cache_dir=, cache_backend=, memo_factory=): "
                "planner-inserted caches arrive with the "
                "plan-inserted-caches slice of repro_torch; wrap a stage "
                "in a cache by hand (ScorerCache(path, stage)) meanwhile")
        self.pipelines: List[Transformer] = list(pipelines)
        self.optimize = optimize
        passes = resolve_passes(optimize)

        # -- layer 1: lowering ---------------------------------------------
        self.graph: PlanGraph = lower(self.pipelines)
        self.nodes_total_naive = sum(plan_size(p) for p in self.pipelines)

        self._node_fps: Optional[Dict[int, str]] = None
        self._plan_id: Optional[str] = None

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
        # cache-place / cache-prune / autotune act only on planner-
        # inserted caches, which this plan never has
        self._label_nodes()
        # the self-describing record is built lazily — fingerprinting
        # every node is only worth paying for when something consumes it
        # (explain(), to_record())
        self._record: Optional[Dict[str, Any]] = None
        self.stats: Optional[PlanStats] = None   # last run

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
        rewrite.  Deterministic across processes."""
        if self._node_fps is None:
            self._node_fps, self._plan_id = plan_fingerprints(self.graph)
        return self._node_fps

    # -- cost layer --------------------------------------------------------
    def _ensure_cost_ctx(self) -> None:
        """Attach a :class:`~repro_torch.core.cost.CostContext` as
        ``graph.cost`` (once): the plan's node fingerprints and an empty
        measured-cost table (measurements persist in the plan manifest
        of a ``cache_dir``, which comes with planner-inserted caches).
        Consumed by the ``operand-order`` pass."""
        if self.graph.cost is not None:
            return
        self.graph.cost = CostContext(
            model=CostModel.from_manifest(None),
            fps=self.node_fingerprints())

    # -- explain / manifests ------------------------------------------------
    def _build_record(self) -> Dict[str, Any]:
        """The plan's self-describing record: structure, provenance,
        optimizer accounting, in the reference's plan-manifest format.
        Rendered by ``explain()``."""
        from ..caching.provenance import PLAN_MANIFEST_VERSION
        fps = self.node_fingerprints()
        plan_id = self._plan_id      # the fingerprints' last level
        nodes = []
        for node in self.graph.nodes:
            if node.kind == "source":
                continue                 # rendered implicitly as <source>
            nodes.append({
                "id": node.id,
                "label": node.label,
                "kind": node.kind,
                "relation": node.relation,
                "fingerprint": fps[node.id],
                "dir": None,             # no planner-inserted cache
                "family": None,
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
            "cache_backend": None,
            "on_stale": "error",
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
        (``cost[est=… act=… src=…]``, actuals from the last run)."""
        record = self.to_record()
        if self.stats is not None and self.stats.node_times_s:
            # no manifest to carry measured costs (in-memory plan):
            # overlay this run's actuals so explain() still shows them
            record = copy.deepcopy(record)
            fold_costs(record, self.stats)
        return render_explain(record)

    def to_record(self) -> Dict[str, Any]:
        """The plan-manifest record (see ``_build_record``), built on
        first use."""
        if self._record is None:
            self._record = self._build_record()
        return self._record

    def close(self) -> None:
        """Nothing to release: the plan holds no caches of its own."""

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
        naive per-pipeline execution.

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
        stats = self._new_stats()
        stats.n_queries = len(frame)
        rec = _Recorder()
        if shards <= 1 and workers <= 1:
            outs = run_sequential(self.graph, frame, batch_size, rec)
        else:
            outs, bounds = run_concurrent(self.graph, frame, batch_size,
                                          shards, workers, rec)
            stats.n_shards = len(bounds)
            stats.n_workers = workers
        self._fill_exec_stats(stats, rec)
        self._finalize_stats(stats, t0)
        if stats.n_shards > 1 or stats.n_workers > 1:
            busy = sum(b - a for _, _, a, b in rec.records)
            stats.occupancy = busy / (workers * stats.wall_time_s) \
                if stats.wall_time_s > 0 else 0.0
        return outs, stats

    def _new_stats(self) -> PlanStats:
        agg = self._aggregate_pass_stats()
        return PlanStats(
            prefix_len=len(longest_common_prefix(self.pipelines)),
            n_pipelines=len(self.pipelines),
            nodes_total=self.nodes_total_naive,
            nodes_planned=self.n_nodes(),
            optimizer_passes=[p.name for p in self.pass_stats],
            nodes_eliminated=agg["nodes_eliminated"],
            cutoffs_pushed=agg["cutoffs_pushed"],
            pass_times_s=self._pass_times())

    def _pass_times(self) -> Dict[str, float]:
        """Per-pass wall time, summed over repeated rounds of a pass."""
        times: Dict[str, float] = {}
        for p in self.pass_stats:
            times[p.name] = round(times.get(p.name, 0.0) + p.time_s, 6)
        return times

    def _fill_exec_stats(self, stats: PlanStats, rec: _Recorder) -> None:
        executed = set()
        for label, s, a, b in rec.records:
            executed.add(label)
            stats.node_times_s[label] = \
                stats.node_times_s.get(label, 0.0) + (b - a)
            stats.node_exec_counts[label] = \
                stats.node_exec_counts.get(label, 0) + 1
        stats.nodes_executed = len(executed)
        if stats.n_shards > 1:
            for s in range(stats.n_shards):
                spans = [(a, b) for _, sh, a, b in rec.records if sh == s]
                stats.shard_times_s.append(
                    max(b for _, b in spans) - min(a for a, _ in spans)
                    if spans else 0.0)

    def _finalize_stats(self, stats: PlanStats, t0: float) -> None:
        stats.stage_invocations_saved = \
            stats.nodes_total - stats.nodes_executed
        stats.wall_time_s = time.perf_counter() - t0
        if stats.n_shards > 1 and stats.wall_time_s > 0 \
                and stats.shard_times_s \
                and stats.speedup_vs_sequential is None:
            # sum of per-shard busy spans ≈ the sequential wall this run
            # would have taken; benchmarks overwrite with a measured ratio
            stats.speedup_vs_sequential = round(
                sum(stats.shard_times_s) / stats.wall_time_s, 2)
        self.stats = stats
