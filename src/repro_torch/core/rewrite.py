"""Optimizer passes over the logical plan IR (``core/ir.py``).

Counterpart of ``repro.core.rewrite``, with all seven passes.

The optimizer is an ordered pass pipeline; each pass is a
``(PlanGraph) -> PassStats`` rewrite with its own accounting, selected
through ``ExecutionPlan(optimize=...)``:

* ``"normalize"`` — algebraic normalization: annotates every node with
  a *canonical* structural key in which the operands of commutative
  operators (``a + b`` / ``b + a``, ``a | b`` / ``b | a``) compare
  equal, so CSE can share them.  Annotation-only: no node is rewritten,
  and a lone ``b + a`` keeps its own evaluation order (row order of the
  output frame is only ever affected for expressions that actually get
  merged with a commuted twin).
* ``"cse"`` — cross-pipeline common-subexpression elimination:
  hash-conses the forest bottom-up on (canonical) structural keys, so
  *any* identical subtree — prefix or not, through binary operators —
  executes once.  Strictly generalizes the prefix trie of
  ``precompute.py`` and subsumes the §3 LCP.
* ``"pushdown"`` — ``RankCutoff`` (``% k``) pushdown: a cutoff climbs
  through ``rank_preserving`` single-consumer stages and, when it
  reaches a stage that can absorb it (``Transformer.with_cutoff``,
  e.g. a retriever's ``num_results`` or the dense stage's per-block
  kernel k), is fused away entirely.  Invariant: **pushdown only
  climbs rank-preserving sole-consumer edges** — a shared (multi-
  consumer) node is never rewritten, so pushdown cannot duplicate
  work that CSE shares or deepen another pipeline's view of the node;
  and absorption is sound only because ``with_cutoff`` implementations
  guarantee a deterministic total order (score desc, then doc index),
  making every top-k a prefix of the top-n.
* ``"cache-prune"`` — cache-aware pruning (runs after planner memo
  insertion): consults the provenance manifests (``caching/provenance``)
  of planner-inserted caches and, for memo nodes whose store is warm
  and whose output is assembled purely from the store
  (``serve_from_store``), marks exclusive ``augment_only`` upstream
  stages as *deferred*: the executor probes the cache with the
  upstream chain's input first and only executes the chain on a miss.
  Invariant: only **exclusive, augment-only** upstream chains are
  deferred — augment-only stages cannot alter the keys the memo is
  probed with, and exclusivity guarantees no other consumer observes
  the skipped intermediate.

Three further passes are *cost-aware*: they consume the
:class:`~repro_torch.core.cost.CostContext` the planner attaches as
``graph.cost`` (measured EWMA costs from the plan manifest, roofline
cold-start priors, microbenchmarked cache round-trips) and no-op
without one:

* ``"operand-order"`` — physically orders the operands of commutative
  combines so the expensive subtree is evaluated first, and annotates
  every node with a critical-path ``sched_priority`` the concurrent
  executor uses to dispatch long-pole tasks first.  Guarded to
  rank-preserving-safe cases: only operators declaring
  ``commutative=True`` (whose ``combine`` is symmetric) are reordered,
  and memo digests / provenance fingerprints key off
  commutative-canonical forms, so a swap never cools a warm cache.
* ``"cache-place"`` — skips planner-inserted caches on nodes whose
  estimated recompute is cheaper than the measured backend round-trip
  (a memo there only adds latency and disk), and promotes hot
  expensive nodes on a bare disk backend to a ``tiered:<disk>``
  memory-fronted selector.  Skipping requires *measured or analytic*
  evidence — a default prior never loses a cache — and never fires
  when the round-trip is cheaper than recompute.
* ``"autotune"`` — chooses executor/serving knobs (``n_shards``,
  ``max_batch`` / ``max_wait_ms``) from the manifest's measured run
  history and online batch-occupancy / queue-depth stats, surfaced as
  ``graph.tuning`` / ``ExecutionPlan.tuning()`` (the reference's
  ``serve`` reads them through ``max_batch="auto"``; the port's
  serving comes with a later slice).

Invariant: for any pipeline algebra, results with
``optimize="all"`` and ``optimize="none"`` — and with the cost-aware
passes on or off — are bit-identical per qid — same (qid, docno,
score, rank) values under canonical row order — in both the sequential
and the sharded executor.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .ir import IRNode, PlanGraph, make_stage_node, node_key
from .pipeline import RankCutoff

__all__ = ["PassStats", "OPTIMIZER_PASSES", "PRE_MEMO_PASSES",
           "PLACEMENT_PASSES", "POST_MEMO_PASSES", "resolve_passes",
           "run_pass"]

#: canonical pass order; ``optimize="all"`` runs exactly these.
#: ``operand-order`` always runs after the structural passes (and after
#: the planner's conditional normalize+cse re-round); ``cache-place``
#: runs between the pre passes and memo insertion; the post-memo passes
#: consult freshly opened cache manifests.
PRE_MEMO_PASSES: Tuple[str, ...] = ("normalize", "cse", "pushdown",
                                    "operand-order")
PLACEMENT_PASSES: Tuple[str, ...] = ("cache-place",)
POST_MEMO_PASSES: Tuple[str, ...] = ("cache-prune", "autotune")
OPTIMIZER_PASSES: Tuple[str, ...] = (PRE_MEMO_PASSES + PLACEMENT_PASSES
                                     + POST_MEMO_PASSES)


@dataclass
class PassStats:
    """Per-pass accounting (surfaced via ``PlanStats`` and ``explain()``)."""
    name: str
    nodes_before: int = 0
    nodes_after: int = 0
    nodes_eliminated: int = 0            # removed from the DAG
    cutoffs_pushed: int = 0              # RankCutoffs moved/absorbed
    nodes_marked_prunable: int = 0       # deferred behind a warm cache
    nodes_annotated: int = 0             # normalize: commuted canonical keys
    caches_skipped: int = 0              # cache-place: memos not inserted
    caches_promoted: int = 0             # cache-place: memory-fronted memos
    inputs_reordered: int = 0            # operand-order: swapped operands
    knobs_tuned: int = 0                 # autotune: knobs written
    time_s: float = 0.0

    def as_dict(self) -> Dict:
        return {"name": self.name, "nodes_before": self.nodes_before,
                "nodes_after": self.nodes_after,
                "nodes_eliminated": self.nodes_eliminated,
                "cutoffs_pushed": self.cutoffs_pushed,
                "nodes_marked_prunable": self.nodes_marked_prunable,
                "nodes_annotated": self.nodes_annotated,
                "caches_skipped": self.caches_skipped,
                "caches_promoted": self.caches_promoted,
                "inputs_reordered": self.inputs_reordered,
                "knobs_tuned": self.knobs_tuned,
                "time_s": round(self.time_s, 6)}


def resolve_passes(optimize: Union[str, Sequence[str], None]) -> List[str]:
    """Validate the ``optimize=`` knob into an ordered pass-name list."""
    if optimize in ("all", True):
        return list(OPTIMIZER_PASSES)
    if optimize in ("none", None, False):
        return []
    if isinstance(optimize, str):
        raise ValueError(
            f"optimize must be 'all', 'none' or a list of pass names "
            f"drawn from {list(OPTIMIZER_PASSES)}; got {optimize!r}")
    names = list(optimize)
    for n in names:
        if n not in OPTIMIZER_PASSES:
            raise ValueError(f"unknown optimizer pass {n!r}; "
                             f"known passes: {list(OPTIMIZER_PASSES)}")
    return names


def run_pass(graph: PlanGraph, name: str) -> PassStats:
    """Run one pass by name, returning its stats."""
    fn = {"normalize": _pass_normalize, "cse": _pass_cse,
          "pushdown": _pass_pushdown, "cache-prune": _pass_cache_prune,
          "operand-order": _pass_operand_order,
          "cache-place": _pass_cache_place,
          "autotune": _pass_autotune}[name]
    stats = PassStats(name=name, nodes_before=graph.n_nodes())
    t0 = time.perf_counter()
    fn(graph, stats)
    stats.time_s = time.perf_counter() - t0
    stats.nodes_after = graph.n_nodes()
    return stats


def _touch(node: IRNode, name: str) -> None:
    if name not in node.touched_by:
        node.touched_by.append(name)


# ---------------------------------------------------------------------------
# normalize — commutative-canonical keys
# ---------------------------------------------------------------------------

def _pass_normalize(graph: PlanGraph, stats: PassStats) -> None:
    for node in graph.nodes:
        if node.kind == "source":
            node.canon_key = node.key
            continue
        in_keys = [i.canon_key if i.canon_key is not None else i.key
                   for i in node.inputs]
        if node.kind == "combine":
            ordered = in_keys
            if getattr(node.stage, "commutative", False):
                ordered = sorted(in_keys, key=repr)
                if ordered != in_keys:
                    stats.nodes_annotated += 1
                    _touch(node, "normalize")
            node.canon_key = ("combine", type(node.stage).__name__,
                              *ordered)
        elif node.kind == "scale":
            node.canon_key = ("scale", node.stage.scalar, in_keys[0])
        else:
            node.canon_key = ("stage", node.stage.signature(), in_keys[0])


# ---------------------------------------------------------------------------
# cse — hash-consing on (canonical) keys
# ---------------------------------------------------------------------------

def _pass_cse(graph: PlanGraph, stats: PassStats) -> None:
    seen: Dict[Tuple, IRNode] = {}
    replace: Dict[int, IRNode] = {}
    kept: List[IRNode] = []
    for node in graph.nodes:
        new_inputs = [replace.get(i.id, i) for i in node.inputs]
        if any(n is not o for n, o in zip(new_inputs, node.inputs)):
            node.inputs = new_inputs
            # keep the structural key consistent with the rewired inputs
            node.key = node_key(node.kind, node.stage, node.inputs)
        k = node.canon_key if node.canon_key is not None else node.key
        rep = seen.get(k)
        if rep is None:
            seen[k] = node
            kept.append(node)
        else:
            replace[node.id] = rep
            _touch(rep, "cse")
            stats.nodes_eliminated += 1
    graph.nodes = kept
    graph.terminals = [replace.get(t.id, t) for t in graph.terminals]


# ---------------------------------------------------------------------------
# pushdown — RankCutoff through rank-preserving stages into absorbers
# ---------------------------------------------------------------------------

def _pass_pushdown(graph: PlanGraph, stats: PassStats) -> None:
    # iterate to a fixpoint: absorbing `% 50 % 10` takes two rounds
    while _pushdown_round(graph, stats):
        pass


def _pushdown_round(graph: PlanGraph, stats: PassStats) -> bool:
    consumers = graph.consumers()
    terminal_ids = {t.id for t in graph.terminals}

    def sole_inner(node: IRNode) -> bool:
        """True when ``node`` feeds exactly one consumer and is not a
        pipeline output itself — the only place a rewrite cannot
        duplicate or change shared work."""
        return len(consumers.get(node.id, ())) == 1 \
            and node.id not in terminal_ids

    for node in graph.nodes:
        if node.kind != "stage" or not isinstance(node.stage, RankCutoff):
            continue
        k = node.stage.k
        chain: List[IRNode] = []         # rank-preserving stages, cutoff-down
        cur = node.inputs[0]
        absorber: Optional[IRNode] = None
        absorbed = None
        while cur.kind == "stage" and sole_inner(cur):
            absorbed = cur.stage.with_cutoff(k)
            if absorbed is not None:
                absorber = cur
                break
            if not cur.rank_preserving:
                break
            chain.append(cur)
            cur = cur.inputs[0]
        if absorber is None and not chain:
            continue

        if absorber is not None:
            # fuse the cutoff into the absorber; rebuild the chain on top
            if absorbed is absorber.stage:
                top = absorber           # already <= k results: cutoff no-op
            else:
                top = make_stage_node(graph, absorbed, absorber.inputs[0])
                _touch(top, "pushdown")
            for st in reversed(chain):
                top = make_stage_node(graph, st.stage, top)
                _touch(top, "pushdown")
            replacement = top
            stats.nodes_eliminated += 1  # the cutoff node itself
        else:
            # no absorber: move the cutoff below the rank-preserving
            # chain so downstream stages only see k rows per query
            top = make_stage_node(graph, node.stage, chain[-1].inputs[0])
            _touch(top, "pushdown")
            for st in reversed(chain):
                top = make_stage_node(graph, st.stage, top)
                _touch(top, "pushdown")
            replacement = top
        stats.cutoffs_pushed += 1

        # rewire every consumer of the cutoff (and the terminals) onto
        # the rebuilt chain, then drop unreachable originals
        for consumer in consumers.get(node.id, ()):
            consumer.inputs = [replacement if i is node else i
                               for i in consumer.inputs]
            consumer.key = node_key(consumer.kind, consumer.stage,
                                    consumer.inputs)
        graph.terminals = [replacement if t is node else t
                           for t in graph.terminals]
        graph.retopo()
        return True
    return False


# ---------------------------------------------------------------------------
# cache-prune — defer exclusive augment-only chains behind warm caches
# ---------------------------------------------------------------------------

def _pass_cache_prune(graph: PlanGraph, stats: PassStats) -> None:
    consumers = graph.consumers()
    terminal_ids = {t.id for t in graph.terminals}
    for node in graph.nodes:
        cache = node.cache
        if cache is None or not hasattr(cache, "serve_from_store"):
            continue                     # only store-complete families
        manifest = getattr(cache, "manifest", None)
        if manifest is None or not getattr(manifest, "entry_count", 0):
            continue                     # cold store: nothing to defer to
        key_cols = set(getattr(cache, "key_cols", ()) or ())
        chain: List[IRNode] = []
        cur = node.inputs[0]
        while cur.kind == "stage" and cur.augment_only \
                and cur.cache is None and cur.id not in terminal_ids \
                and len(consumers.get(cur.id, ())) == 1 \
                and not (key_cols & set(
                    getattr(cur.stage, "value_columns", ()) or ())):
            # the last guard: an augment-only stage that *produces* one
            # of the cache's key columns (a query/text attacher) cannot
            # be deferred — the probe frame would lack (or mis-value)
            # that key.  serve_from_store additionally treats a missing
            # key column as a miss, so undeclared producers stay safe.
            chain.append(cur)
            cur = cur.inputs[0]
        if not chain:
            continue
        node.probe_input = cur
        node.inline_chain = list(reversed(chain))   # execution order
        for ch in chain:
            ch.inlined = True
            _touch(ch, "cache-prune")
        _touch(node, "cache-prune")
        stats.nodes_marked_prunable += len(chain)


# ---------------------------------------------------------------------------
# operand-order — expensive subtree first + critical-path priorities
# ---------------------------------------------------------------------------

def _pass_operand_order(graph: PlanGraph, stats: PassStats) -> None:
    cost = graph.cost
    if cost is None:
        return                           # cost-blind compile: no-op
    for node in graph.nodes:
        if node.kind == "source":
            continue
        node.cost_est_s, node.cost_src = cost.estimate(node)
        stats.nodes_annotated += 1

    # 1) physical operand order: evaluate the expensive subtree of a
    #    commutative combine first, so both the sequential executor and
    #    the priority scheduler start the long pole earliest.  Safe only
    #    for operators whose combine() is symmetric (commutative=True);
    #    the 1.2x hysteresis keeps near-ties from flapping run to run.
    swapped = False
    for node in graph.nodes:
        if node.kind != "combine" \
                or not getattr(node.stage, "commutative", False) \
                or len(node.inputs) != 2:
            continue
        a, b = node.inputs
        if cost.subtree_cost(b) > 1.2 * cost.subtree_cost(a):
            node.inputs = [b, a]
            _touch(node, "operand-order")
            stats.inputs_reordered += 1
            swapped = True
    if swapped:
        # structural keys embed input keys: rebuild them topologically
        for node in graph.nodes:
            if node.kind != "source":
                node.key = node_key(node.kind, node.stage, node.inputs)
        cost.invalidate_subtrees()
    # canonical keys must be fresh whenever this pass ran — planner memo
    # digests key off canon_key, which is invariant under the swaps above
    _pass_normalize(graph, PassStats(name="normalize"))

    # 2) critical-path priorities: a node's priority is its own cost
    #    plus the costliest downstream path; the concurrent executor
    #    pops high-priority ready nodes first.  Scheduling metadata
    #    only — results are unaffected.
    consumers = graph.consumers()
    for node in reversed(graph.nodes):   # reverse topological order
        downstream = max(
            (c.sched_priority for c in consumers.get(node.id, ())),
            default=0.0)
        node.sched_priority = (node.cost_est_s or 0.0) + downstream


# ---------------------------------------------------------------------------
# cache-place — skip cheap memos, memory-front hot expensive ones
# ---------------------------------------------------------------------------

def _pass_cache_place(graph: PlanGraph, stats: PassStats) -> None:
    cost = graph.cost
    if cost is None or cost.round_trip_s is None:
        return                           # no caches planned: no-op
    rt = cost.round_trip_s
    for node in graph.nodes:
        if node.kind != "stage":
            continue
        est, src = cost.estimate(node)
        node.cost_est_s, node.cost_src = est, src
        if src == "default":
            continue                     # weak evidence: never lose a cache
        # the alternative to recomputing is the node's cache path.  Its
        # cheapest defensible figure: the microbenchmarked per-entry
        # round trip, tightened by the measured per-query cache-path
        # cost when one exists (min, never max — a cold run's figure is
        # write-heavy and would overstate the steady-state read path,
        # flushing caches that a warm run would have justified)
        cache_s = cost.model.measured_cache_cost(cost.fps.get(node.id))
        alt = rt if cache_s is None else min(rt, cache_s)
        if est * 2.0 < alt:
            # recompute is comfortably cheaper than even the cheapest
            # view of the cache path: a memo here only adds latency and
            # disk.  By construction this cannot fire when the cache
            # path is the cheaper side (alt < est implies est*2 >= alt).
            node.cache_skip = True
            _touch(node, "cache-place")
            stats.caches_skipped += 1
        elif est > 20.0 * rt:
            # hot AND expensive: even the per-entry round trip is worth
            # shaving — front the same persistent store with a memory
            # tier (storage identity is unchanged, dirs stay warm)
            promoted = _promote_selector(cost.backend)
            if promoted is not None:
                node.backend_override = promoted
                _touch(node, "cache-place")
                stats.caches_promoted += 1


def _promote_selector(backend: Optional[str]) -> Optional[str]:
    """``tiered:<disk>`` over a bare persistent disk backend — hot
    expensive nodes get a memory front.  Storage identity is unchanged
    (``caching.backends.storage_identity`` resolves through tiers), so
    warm dirs written by the bare backend stay valid."""
    if not backend:
        return None
    from ..caching.backends import BACKENDS, split_combinator
    if split_combinator(backend) is not None:
        return None                      # already a combinator selector
    cls = BACKENDS.get(backend)
    if cls is None or not cls.persistent:
        return None                      # memory-only: nothing to front
    return f"tiered:{backend}"


# ---------------------------------------------------------------------------
# autotune — executor / serving knobs from measured history
# ---------------------------------------------------------------------------

def _pass_autotune(graph: PlanGraph, stats: PassStats) -> None:
    cost = graph.cost
    if cost is None:
        return
    tuning: Dict[str, Dict[str, Any]] = {}
    history = [r for r in (cost.history or []) if isinstance(r, dict)]

    # -- n_shards: prefer direct evidence (the fastest measured
    #    per-query configuration across prior runs); otherwise estimate
    #    from measured per-node costs.
    by_shards: Dict[int, List[float]] = {}
    for r in history:
        nq = int(r.get("n_queries") or 0)
        wall = r.get("wall_time_s")
        if nq > 0 and isinstance(wall, (int, float)) and wall > 0:
            ns = int(r.get("n_shards") or 1)
            by_shards.setdefault(ns, []).append(float(wall) / nq)
    if len(by_shards) > 1:
        best = min(by_shards, key=lambda ns: min(by_shards[ns]))
        tuning["n_shards"] = {"value": best, "source": "measured-history"}
    else:
        stage_nodes = [n for n in graph.nodes if n.kind == "stage"]
        estimates = [cost.estimate(n) for n in stage_nodes]
        if stage_nodes and all(n.shardable for n in stage_nodes) \
                and any(src == "measured" for _, src in estimates) \
                and sum(est for est, _ in estimates) > 2e-3:
            want = min(8, max(2, os.cpu_count() or 4))
            tuning["n_shards"] = {"value": want, "source": "cost-model"}

    # -- micro-batch knobs from the latest run that carried online
    #    (streaming-executor) stats
    online = next((r["online"] for r in reversed(history)
                   if isinstance(r.get("online"), dict)), None)
    if online:
        occ = float(online.get("batch_occupancy") or 0.0)
        prev_batch = int(online.get("max_batch") or 16)
        if occ >= 0.9:
            batch = min(256, prev_batch * 2)     # saturated: give headroom
        elif 0 < occ < 0.25:
            batch = max(4, prev_batch // 2)      # mostly empty: shrink
        else:
            batch = prev_batch
        tuning["max_batch"] = {"value": batch, "source": "batch-occupancy"}
        wait = float(online.get("max_wait_ms") or 2.0)
        if occ < 0.25 and float(online.get("queue_depth_p99") or 0.0) < 1.0:
            wait = max(0.5, wait / 2.0)          # idle queue: cut latency
        tuning["max_wait_ms"] = {"value": wait, "source": "queue-depth"}

    graph.tuning = tuning
    stats.knobs_tuned = len(tuning)
