"""Optimizer passes over the logical plan IR (``core/ir.py``).

Counterpart of ``repro.core.rewrite`` with its four structural passes.

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
* ``"cache-prune"`` — cache-aware pruning behind warm planner-inserted
  caches (runs after memo insertion).

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
* ``"cache-place"`` — skips or memory-fronts planner-inserted caches;
* ``"autotune"`` — chooses executor/serving knobs from measured history.

``cache-prune``, ``cache-place`` and ``autotune`` run only when a plan
inserts caches, which the port's ``ExecutionPlan`` does not do yet:
their names stay in the registry, so ``optimize="all"`` resolves the
reference's list, and running one raises ``NotImplementedError``.

Invariant: for any pipeline algebra, results with ``optimize="all"``
and ``optimize="none"`` — and with the cost-aware passes on or off —
are bit-identical per qid — same (qid, docno, score, rank) values under
canonical row order — in both the sequential and the sharded executor.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

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
    if name in PLACEMENT_PASSES + POST_MEMO_PASSES:
        raise NotImplementedError(
            f"optimizer pass {name!r} acts on planner-inserted caches, "
            f"which arrive with the plan-inserted-caches slice of "
            f"repro_torch")
    fn = {"normalize": _pass_normalize, "cse": _pass_cse,
          "pushdown": _pass_pushdown,
          "operand-order": _pass_operand_order}[name]
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
