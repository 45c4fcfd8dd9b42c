"""Logical IR for the plan compiler (lowering layer).

Counterpart of ``repro.core.ir``, copied: it is plain Python.  The
planner is a small compiler with three layers:

* **this module** — the logical IR: pipeline expressions are *lowered*
  into a forest of :class:`IRNode` DAG nodes, one node per syntactic
  operator occurrence, with the transformer metadata the optimizer
  needs (``relation`` type, ``shardable``, ``rank_preserving``,
  ``augment_only``) lifted onto the node at lowering time;
* ``core/rewrite.py`` — the optimizer: an ordered pass pipeline
  (normalize / cse / pushdown / operand-order) rewriting the graph;
* ``core/executor.py`` — the physical layer: the sequential and
  sharded-wavefront schedulers.

Lowering itself performs **no sharing**: ``optimize="none"`` executes
the forest as-is (one invocation per syntactic occurrence — the naive
baseline of the source paper's tables), and every bit of sharing is an
explicit, accounted optimizer pass.  ``ExecutionPlan`` (``core/plan.py``)
remains the façade over all three layers.

Nodes are value-like: the structural fields (``key``, ``kind``,
``stage``, lifted metadata) are fixed at construction and rewrite
passes build *new* nodes instead of editing structure in place; only
annotations (labels, memo caches, pass markers) are added after the
fact.

Invariants this layer guarantees (what the optimizer passes rely on):

* **one node per syntactic occurrence** — lowering never merges, so
  every unit of sharing is attributable to a named pass;
* **keys are structural identity** — two nodes with equal ``key``
  compute bit-identical frames from equal inputs (transformer equality
  is ``signature()`` equality and transformers are deterministic),
  which is the entire soundness argument of CSE;
* **metadata is lifted once and never edited** — ``rank_preserving``
  licenses pushdown to climb an edge, ``with_cutoff`` to absorb,
  ``augment_only`` licenses cache-prune to defer, ``shardable``
  licenses the executor to partition the query frame.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .frame import D, Q, R
from .pipeline import Compose, ScalarProduct, Transformer, _Binary

__all__ = ["IRNode", "PlanGraph", "lower", "make_stage_node", "node_key",
           "plan_size", "render_explain"]


@dataclass
class IRNode:
    """One unit of work in the logical DAG.

    ``key`` is the canonical *structural* identity (recursive over the
    inputs' keys) — two nodes with equal keys compute the same relation.
    ``id`` is the per-graph instance identity: before common-subexpression
    elimination several nodes may share a key, so executors and passes
    address nodes by ``id``, never by ``key``.
    """
    id: int
    key: Tuple                           # canonical structural key
    kind: str                            # "source" | "stage" | "combine" | "scale"
    stage: Optional[Transformer]         # operator instance (None for source)
    inputs: List["IRNode"] = field(default_factory=list)
    # -- metadata lifted from the Transformer at lowering time -------------
    relation: Optional[str] = None       # static Q/D/R classification
    shardable: bool = True               # row-local per qid (see pipeline.py)
    rank_preserving: bool = False        # RankCutoff commutes through it
    augment_only: bool = False           # output = input + extra columns
    # -- optimizer / executor annotations ----------------------------------
    canon_key: Optional[Tuple] = None    # normalize pass: commutative-canonical
    touched_by: List[str] = field(default_factory=list)
    cache: Optional[Transformer] = None  # planner-inserted memo wrapper
    probe_input: Optional["IRNode"] = None   # cache-prune: lookup-first input
    inline_chain: List["IRNode"] = field(default_factory=list)
    inlined: bool = False                # deferred into the consumer's task
    label: str = ""                      # unique display label
    # -- cost layer (core/cost.py) annotations -----------------------------
    cost_est_s: Optional[float] = None   # per-query estimate (seconds)
    cost_src: Optional[str] = None       # "measured" | "analytic" | "default"
    sched_priority: float = 0.0          # critical-path rank (operand-order)
    cache_skip: bool = False             # cache-place: cheaper to recompute
    backend_override: Optional[str] = None   # cache-place: hot-node promotion
    # -- asynchronous data plane (caching/dataplane.py) ---------------------
    #: plan-stamped: executors issue this node's cache reads on the I/O
    #: pool as soon as the feeding frame exists (False for graphs built
    #: outside ExecutionPlan — lowering alone never prefetches)
    prefetch: bool = False

    def __hash__(self) -> int:           # identity-hashed for set membership
        return self.id

    def __eq__(self, other) -> bool:
        return self is other


#: transformer classes whose combine output keeps scores (R relation)
_R_COMBINES = ("LinearCombine", "FeatureUnion", "Concatenate")


def _static_relation(kind: str, stage: Optional[Transformer]) -> Optional[str]:
    """Best-effort static output-relation classification for display."""
    if kind == "source":
        return "Q"
    if kind in ("scale",):
        return "R"
    if kind == "combine":
        return "R" if type(stage).__name__ in _R_COMBINES else "D"
    cols = getattr(stage, "output_columns", None)
    if cols:
        cols = set(cols)
        for name, req in (("R", R), ("Q", Q), ("D", D)):
            if req <= cols:
                return name
    if getattr(stage, "one_to_many", False):
        return "R"
    return None


class PlanGraph:
    """The lowered forest: nodes in topological order, source first."""

    def __init__(self, pipelines: Sequence[Transformer]):
        self.pipelines: List[Transformer] = list(pipelines)
        self._next_id = 0
        self.source = IRNode(id=self._take_id(), key=("source",),
                             kind="source", stage=None, relation="Q")
        self.nodes: List[IRNode] = [self.source]
        self.terminals: List[IRNode] = []
        #: cost layer (``core/cost.py``): a ``CostContext`` once the
        #: planner attaches one; cost-aware passes no-op without it
        self.cost: Optional[Any] = None
        #: autotune pass output: recommended executor/serving knobs
        #: (``n_shards`` / ``max_batch`` / ``max_wait_ms``) with evidence
        self.tuning: Dict[str, Any] = {}

    def _take_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    def add(self, key: Tuple, kind: str, stage: Transformer,
            inputs: List[IRNode]) -> IRNode:
        node = IRNode(
            id=self._take_id(), key=key, kind=kind, stage=stage,
            inputs=list(inputs),
            relation=_static_relation(kind, stage),
            shardable=bool(getattr(stage, "shardable", True))
            if kind == "stage" else True,
            rank_preserving=bool(getattr(stage, "rank_preserving", False)),
            augment_only=bool(getattr(stage, "augment_only", False)))
        self.nodes.append(node)
        return node

    # -- structural helpers -------------------------------------------------
    def consumers(self) -> Dict[int, List[IRNode]]:
        """node id → nodes consuming it (terminal uses not included)."""
        out: Dict[int, List[IRNode]] = {}
        for node in self.nodes:
            for inp in node.inputs:
                out.setdefault(inp.id, []).append(node)
        return out

    def retopo(self) -> None:
        """Rebuild ``nodes`` as the set reachable from the terminals, in
        topological (inputs-first) order; unreachable nodes are dropped.
        Rewrite passes call this after rewiring edges."""
        order: List[IRNode] = []
        seen = set()

        def visit(node: IRNode) -> None:
            if node.id in seen:
                return
            seen.add(node.id)
            for inp in node.inputs:
                visit(inp)
            order.append(node)

        visit(self.source)
        for t in self.terminals:
            visit(t)
        self.nodes = order

    def n_nodes(self) -> int:
        return len(self.nodes) - 1       # exclude the source


def node_key(kind: str, stage: Optional[Transformer],
             inputs: Sequence[IRNode]) -> Tuple:
    """The canonical structural key for a node — the single source of
    truth for key shapes, used by lowering and by rewrite passes when
    they synthesize nodes or rewire inputs."""
    if kind == "source":
        return ("source",)
    if kind == "combine":
        return ("combine", type(stage).__name__,
                inputs[0].key, inputs[1].key)
    if kind == "scale":
        return ("scale", stage.scalar, inputs[0].key)
    return ("stage", stage.signature(), inputs[0].key)


def make_stage_node(graph: PlanGraph, stage: Transformer,
                    inp: IRNode) -> IRNode:
    """A fresh stage node applied to ``inp`` (shared by lowering and by
    rewrite passes that synthesize nodes, so metadata lifting is uniform)."""
    return graph.add(node_key("stage", stage, [inp]), "stage", stage, [inp])


def lower(pipelines: Sequence[Transformer]) -> PlanGraph:
    """Lower a pipeline set into the logical IR forest.

    One node per syntactic operator occurrence — deduplication is the
    optimizer's job (``core/rewrite.py``), so ``optimize="none"``
    faithfully models naive per-pipeline execution.
    """
    graph = PlanGraph(pipelines)

    def rec(expr: Transformer, inp: IRNode) -> IRNode:
        if isinstance(expr, Compose):
            node = inp
            for stage in expr.stages:
                node = rec(stage, node)
            return node
        if isinstance(expr, _Binary):
            left = rec(expr.left, inp)
            right = rec(expr.right, inp)
            return graph.add(node_key("combine", expr, [left, right]),
                             "combine", expr, [left, right])
        if isinstance(expr, ScalarProduct):
            inner = rec(expr.inner, inp)
            return graph.add(node_key("scale", expr, [inner]),
                             "scale", expr, [inner])
        return make_stage_node(graph, expr, inp)

    graph.terminals = [rec(p, graph.source) for p in pipelines]
    return graph


def plan_size(expr: Transformer) -> int:
    """Stage invocations of one *naive* execution of ``expr`` (binary
    operators expand into 1 + both children, unlike ``stages_of``)."""
    if isinstance(expr, Compose):
        return sum(plan_size(s) for s in expr.stages)
    if isinstance(expr, _Binary):
        return 1 + plan_size(expr.left) + plan_size(expr.right)
    if isinstance(expr, ScalarProduct):
        return 1 + plan_size(expr.inner)
    return 1


# ---------------------------------------------------------------------------
# explain() rendering — ExecutionPlan.explain() renders its plan-manifest
# record, the same record format the reference's `repro plan explain` reads.
# ---------------------------------------------------------------------------

def _node_line(rec: Dict[str, Any]) -> str:
    parts = [f"#{rec.get('id')}", f"{rec.get('kind')}:{rec.get('label')}"]
    if rec.get("relation"):
        parts.append(f"[{rec['relation']}]")
    fp = rec.get("fingerprint")
    if fp:
        parts.append(f"fp={str(fp)[:12]}")
    if rec.get("family"):
        cache = rec["family"]
        if rec.get("dir"):
            cache += f"@{rec['dir']}"
        parts.append(f"cache={cache}")
    touched = rec.get("touched_by") or []
    if touched:
        parts.append(f"passes={','.join(touched)}")
    est = rec.get("cost_est_s")
    if est is not None:
        cost = f"cost[est={float(est) * 1e3:.3f}ms"
        act = rec.get("cost_act_s")
        if act is not None:
            cost += f" act={float(act) * 1e3:.3f}ms"
        src = rec.get("cost_src")
        if src:
            cost += f" src={src}"
        parts.append(cost + "]")
    if rec.get("cache_skip"):
        parts.append("(cache-skipped)")
    onl = rec.get("online")
    if onl:
        parts.append("online[p50=%.2fms p99=%.2fms n=%d]"
                     % (onl.get("p50_ms", 0.0), onl.get("p99_ms", 0.0),
                        onl.get("executions", 0)))
    if rec.get("probe_input") is not None:
        parts.append(f"probe=#{rec['probe_input']}")
    if rec.get("inlined"):
        parts.append("(pruned-when-warm)")
    return " ".join(str(p) for p in parts)


def render_explain(record: Dict[str, Any]) -> str:
    """ASCII tree of a plan-manifest record: one tree per pipeline,
    shared nodes printed once and referenced afterwards."""
    nodes = record.get("nodes", [])
    by_id = {n["id"]: n for n in nodes if "id" in n}
    lines: List[str] = []
    opt = record.get("optimizer", {})
    passes = opt.get("passes", [])
    lines.append(f"plan {record.get('plan_id', '?')}: "
                 f"{len(record.get('pipelines', []))} pipeline(s), "
                 f"{len([n for n in nodes if n.get('kind') != 'source'])} "
                 f"node(s)")
    lines.append(f"optimizer: passes={passes or ['(none)']} "
                 f"eliminated={opt.get('nodes_eliminated', 0)} "
                 f"cutoffs_pushed={opt.get('cutoffs_pushed', 0)} "
                 f"prunable={opt.get('nodes_marked_prunable', 0)}")
    seen: set = set()

    def visit(node_id: int, prefix: str, tail: bool) -> None:
        rec = by_id.get(node_id)
        branch = "└─ " if tail else "├─ "
        if rec is None:
            lines.append(prefix + branch + f"#{node_id} <source>")
            return
        if node_id in seen:
            lines.append(prefix + branch +
                         f"#{node_id} {rec.get('label')} (shared, see above)")
            return
        seen.add(node_id)
        lines.append(prefix + branch + _node_line(rec))
        inputs = rec.get("inputs", [])
        ext = "   " if tail else "│  "
        for j, inp in enumerate(inputs):
            visit(inp, prefix + ext, j == len(inputs) - 1)

    terminals = record.get("terminals", [])
    for i, tid in enumerate(terminals):
        pipe = record.get("pipelines", [])
        name = pipe[i] if i < len(pipe) else "?"
        lines.append(f"pipeline[{i}]: {name}")
        visit(tid, "", True)
    return "\n".join(lines)
