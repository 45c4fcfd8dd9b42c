"""Cost layer under the plan compiler.

Counterpart of ``repro.core.cost``.  The analytic priors are the
reference's host-roofline estimates (its ``launch/roofline.py``), copied
here with their host constants; its TPU figures are not used.

This module gives the optimizer a :class:`CostModel` blending three
signal sources, in decreasing order of trust:

* **measured** — per-node recompute costs of previous runs
  (``PlanStats.node_times_s`` for uncached nodes; the raw miss-path
  compute channel ``node_compute_s`` for cached ones, so store round
  trips never masquerade as compute), folded back into the plan
  manifest on every run as an exponentially-weighted moving average
  keyed by node *fingerprint*.
  Keying by provenance fingerprint means measured costs survive
  restarts for exactly as long as they are valid: a config or code
  change anywhere upstream changes the fingerprint and the stale
  measurement is simply never looked up again.
* **analytic** — host-roofline estimates (:func:`estimate_stage_cost`)
  for retrieval stages (dense top-k matmul, BM25 postings traversal),
  the cold-start prior before anything has been measured.
* **default** — small per-kind constants so every node has *some*
  estimate.  Defaults are deliberately weak evidence: cost-aware
  rewrites that can lose work (cache skipping) refuse to fire on them.

:class:`CostContext` packages the model with the plan's node
fingerprints and the measured cache round-trip cost of the selected
backend (``caching.backends.measure_round_trip``); ``ExecutionPlan``
attaches it to the graph as ``graph.cost`` for the cost-aware passes
(``operand-order``; ``cache-place`` / ``autotune`` come with the
port's plan-inserted caches).

Invariant: costs influence *scheduling, placement and knobs* only —
never results.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ir import IRNode, PlanGraph

__all__ = ["CostModel", "CostContext", "compute_node_fingerprints",
           "fold_costs", "annotate_node_actuals", "analytic_stage_cost",
           "estimate_stage_cost", "should_prefetch",
           "PREFETCH_MIN_ROUND_TRIP_S", "EWMA_ALPHA", "DEFAULT_STAGE_COST_S",
           "DEFAULT_COMBINE_COST_S", "HOST_PEAK_FLOPS", "HOST_MEM_BW",
           "HOST_DISPATCH_OVERHEAD_S"]

#: EWMA weight of the newest observation (0.4 ≈ the last ~4 runs carry
#: ~87% of the weight — adapts quickly without thrashing on one outlier)
EWMA_ALPHA = 0.4

#: per-query default priors (seconds) — weak evidence, see module doc
DEFAULT_STAGE_COST_S = 2e-4
DEFAULT_COMBINE_COST_S = 2e-5

#: cost figures are rounded before persisting / rendering so the
#: in-process explain() and the JSON-round-tripped CLI agree exactly
COST_DECIMALS = 9


def _round_cost(x: float) -> float:
    return round(float(x), COST_DECIMALS)


def compute_node_fingerprints(graph: PlanGraph) -> Dict[int, str]:
    """Provenance fingerprint per node (id-keyed): the stage fingerprint
    folded over the input nodes' fingerprints, bottom-up.

    For *commutative* combine nodes the input fingerprints fold in
    sorted order, so ``a + b`` and ``b + a`` — and a combine whose
    operands the ``operand-order`` pass swapped — carry the same
    fingerprint.  This keeps measured costs (and cache-manifest
    provenance) stable under the one rewrite that is allowed to change
    physical operand order without changing results.
    """
    from ..caching.auto import derive_fingerprint
    from ..caching.provenance import combine_fingerprints
    fps: Dict[int, str] = {
        graph.source.id: combine_fingerprints("plan-source")}
    # graph.nodes is topological — every input precedes its consumer
    for node in graph.nodes:
        if node.kind == "source":
            continue
        in_fps = [fps[i.id] for i in node.inputs]
        if node.kind == "combine" and getattr(node.stage, "commutative",
                                              False):
            # the binary stage's own signature() embeds its operands'
            # signatures *in order*; the operands are already captured
            # by the (sorted) input fingerprints, so key the stage by
            # class alone — same symmetrization canon_key uses
            stage_fp = combine_fingerprints("combine",
                                            type(node.stage).__name__)
            in_fps = sorted(in_fps)
        else:
            stage_fp = derive_fingerprint(node.stage) \
                or combine_fingerprints("sig", repr(node.stage))
        fps[node.id] = combine_fingerprints(
            "node", node.kind, stage_fp, *in_fps)
    return fps


# host-side roofline priors for the cost model: sustained throughput of
# the *Python/numpy host path* IR stages actually run on, far below any
# device peak.  Deliberately rough — these only seed cost estimates
# until real measurements replace them (copied from the reference's
# ``launch/roofline.py``).
HOST_PEAK_FLOPS = 2e10      # sustained host FLOP/s (BLAS-ish)
HOST_MEM_BW = 5e9           # bytes/s effective host streaming
#: per-query Python dispatch floor added to every host estimate: frame
#: plumbing and interpreter overhead dominate tiny workloads, and an
#: optimistic prior must never claim a stage is cheaper than a cache
#: round-trip (only *measurements* may justify dropping a cache)
HOST_DISPATCH_OVERHEAD_S = 5e-5


def estimate_stage_cost(stage) -> Optional[float]:
    """Analytic per-query cost prior (seconds) for retrieval stages —
    the plan compiler's cold-start estimate before any run has been
    measured.

    Duck-typed on the stage class name: a ``DenseRetriever`` costs one
    row of the matmul + top-k against its corpus matrix, a
    ``BM25Retriever`` one TAAT postings traversal.  The figure is
    ``HOST_DISPATCH_OVERHEAD_S + max(flops / HOST_PEAK_FLOPS,
    bytes / HOST_MEM_BW)`` — the host roofline plus the per-query
    Python dispatch floor.  Returns ``None`` for stages with no
    analytic model (generic transformers fall back to the cost model's
    defaults).
    """
    name = type(stage).__name__
    if name == "DenseRetriever":
        matrix = getattr(getattr(stage, "index", None), "matrix", None)
        shape = getattr(matrix, "shape", None)
        if not shape or len(shape) != 2:
            return None
        n_docs, dim = int(shape[0]), int(shape[1])
        itemsize = int(getattr(matrix, "itemsize", 4) or 4)
        k = int(getattr(stage, "num_results", 100))
        flops = 2.0 * n_docs * dim            # one query row × corpus
        byts = float(n_docs * dim * itemsize) # stream the matrix
        topk = float(n_docs) * max(1.0, math.log2(max(2, k)))
        return HOST_DISPATCH_OVERHEAD_S + max(
            (flops + topk) / HOST_PEAK_FLOPS, byts / HOST_MEM_BW)
    if name == "BM25Retriever":
        index = getattr(stage, "index", None)
        n_docs = getattr(index, "n_docs", None)
        if n_docs is None:
            docnos = getattr(index, "docnos", None)
            n_docs = len(docnos) if docnos is not None else None
        if not n_docs:
            return None
        # TAAT: ~q_terms postings lists, each a fraction of the corpus;
        # model ≈ 4 query terms × 10% selectivity × (ids+tfs+score work)
        postings = 4 * 0.1 * float(n_docs)
        flops = 8.0 * postings                # idf/tf saturation per hit
        byts = 12.0 * postings                # int32 id + f32 tf + accum
        k = int(getattr(stage, "num_results", 1000))
        sort = float(n_docs) * max(1.0, math.log2(max(2, min(k, n_docs))))
        return HOST_DISPATCH_OVERHEAD_S + max(
            (flops + sort) / HOST_PEAK_FLOPS, byts / HOST_MEM_BW)
    return None


def analytic_stage_cost(stage: Any) -> Optional[float]:
    """Roofline cold-start prior for retrieval stages (per-query
    seconds); ``None`` for stages the roofline cannot model."""
    try:
        return estimate_stage_cost(stage)
    except Exception:
        return None


class CostModel:
    """Measured per-node costs, EWMA-folded per node fingerprint.

    The table lives in the plan manifest (``costs`` key) so it survives
    restarts; entries go stale *with provenance* — a changed upstream
    fingerprint is a different key, never a wrong answer.
    """

    def __init__(self, measured: Optional[Dict[str, Dict[str, Any]]] = None):
        self.measured: Dict[str, Dict[str, Any]] = dict(measured or {})

    @classmethod
    def from_manifest(cls, record: Optional[Dict[str, Any]]) -> "CostModel":
        """Rebuild the model from a plan-manifest record (tolerant of
        missing/garbled entries — a cost table is advisory data)."""
        out: Dict[str, Dict[str, Any]] = {}
        costs = (record or {}).get("costs") or {}
        if isinstance(costs, dict):
            for fp, ent in costs.items():
                try:
                    parsed = {
                        "s_per_query": float(ent["s_per_query"]),
                        "n": int(ent.get("n", 1)),
                        "updated_at": float(ent.get("updated_at", 0.0)),
                    }
                    if ent.get("cache_s_per_query") is not None:
                        parsed["cache_s_per_query"] = \
                            float(ent["cache_s_per_query"])
                    out[str(fp)] = parsed
                except (TypeError, KeyError, ValueError):
                    continue
        return cls(out)

    def measured_cost(self, fp: Optional[str]) -> Optional[float]:
        ent = self.measured.get(fp) if fp else None
        return float(ent["s_per_query"]) if ent else None

    def measured_cache_cost(self, fp: Optional[str]) -> Optional[float]:
        """Measured per-query cost of the node's *cache path* (store
        lookups, inserts, [de]serialization — wrapper wall time minus
        raw compute).  The apples-to-apples alternative the cache-place
        pass weighs recompute against: a query may touch many store
        entries, so a per-entry round-trip figure understates it."""
        ent = self.measured.get(fp) if fp else None
        v = ent.get("cache_s_per_query") if ent else None
        return float(v) if v is not None else None

    def observe(self, fp: str, s_per_query: float) -> None:
        """Fold one run's per-query cost for the node ``fp`` into the
        EWMA (first observation seeds the average)."""
        s_per_query = max(0.0, float(s_per_query))
        ent = self.measured.get(fp)
        if ent is None:
            self.measured[fp] = {"s_per_query": _round_cost(s_per_query),
                                 "n": 1, "updated_at": time.time()}
            return
        ewma = (EWMA_ALPHA * s_per_query
                + (1.0 - EWMA_ALPHA) * float(ent["s_per_query"]))
        ent["s_per_query"] = _round_cost(ewma)
        ent["n"] = int(ent.get("n", 1)) + 1
        ent["updated_at"] = time.time()

    def observe_cache(self, fp: str, s_per_query: float) -> None:
        """Fold one run's per-query cache-path cost for the node ``fp``
        (no-op until a recompute cost has been observed: the entry is
        keyed by it)."""
        s_per_query = max(0.0, float(s_per_query))
        ent = self.measured.get(fp)
        if ent is None:
            return
        prev = ent.get("cache_s_per_query")
        if prev is None:
            ent["cache_s_per_query"] = _round_cost(s_per_query)
        else:
            ent["cache_s_per_query"] = _round_cost(
                EWMA_ALPHA * s_per_query + (1.0 - EWMA_ALPHA) * float(prev))

    def to_manifest(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for fp, ent in self.measured.items():
            d = {"s_per_query": _round_cost(ent["s_per_query"]),
                 "n": int(ent.get("n", 1)),
                 "updated_at": float(ent.get("updated_at", 0.0))}
            if ent.get("cache_s_per_query") is not None:
                d["cache_s_per_query"] = _round_cost(ent["cache_s_per_query"])
            out[fp] = d
        return out


@dataclass
class CostContext:
    """Everything a cost-aware pass needs, attached as ``graph.cost``."""

    model: CostModel = field(default_factory=CostModel)
    #: node id → provenance fingerprint (``compute_node_fingerprints``)
    fps: Dict[int, str] = field(default_factory=dict)
    #: resolved backend selector of planner-inserted caches, if any
    backend: Optional[str] = None
    #: measured per-entry cache round-trip of ``backend`` (seconds);
    #: ``None`` when no caches will be inserted (cache-place no-ops)
    round_trip_s: Optional[float] = None
    #: run history from the prior plan manifest (autotune evidence)
    history: List[Dict[str, Any]] = field(default_factory=list)
    _subtree: Dict[int, float] = field(default_factory=dict, repr=False)

    def estimate(self, node: IRNode) -> Tuple[float, str]:
        """Per-query cost estimate for one node and the source of the
        figure: ``"measured"`` > ``"analytic"`` > ``"default"``."""
        m = self.model.measured_cost(self.fps.get(node.id))
        if m is not None:
            return _round_cost(m), "measured"
        if node.kind == "stage":
            a = analytic_stage_cost(node.stage)
            if a is not None:
                return _round_cost(a), "analytic"
            return DEFAULT_STAGE_COST_S, "default"
        return DEFAULT_COMBINE_COST_S, "default"

    def subtree_cost(self, node: IRNode) -> float:
        """Estimated cost of the whole subtree rooted at ``node`` (the
        operand-order pass compares these).  Shared nodes count once
        per reachable path — an upper bound, which is the conservative
        direction for ordering decisions."""
        c = self._subtree.get(node.id)
        if c is None:
            c = self.estimate(node)[0] if node.kind != "source" else 0.0
            for inp in node.inputs:
                c += self.subtree_cost(inp)
            self._subtree[node.id] = c
        return c

    def invalidate_subtrees(self) -> None:
        """Drop memoized subtree costs (after a structural rewrite)."""
        self._subtree.clear()


#: per-entry store round trip (seconds) below which a backend behaves
#: like memory — moving its reads to the I/O pool would only add
#: handoff overhead, so the prefetch gate refuses to stamp such nodes
PREFETCH_MIN_ROUND_TRIP_S = 2e-6


def should_prefetch(round_trip_s: Optional[float], *,
                    overlap_s: Optional[float] = None) -> bool:
    """Cost gate for the asynchronous data plane: is issuing a node's
    warm-path store reads on the background I/O pool worth it?

    * ``round_trip_s`` — measured per-entry round trip of the selected
      backend (``caching.backends.measure_round_trip``); ``None`` means
      unmeasured, which passes the gate — the backend's own
      ``prefetchable`` flag already vetoes memory-speed tiers, so an
      unknown figure is presumed disk-like.
    * ``overlap_s`` — optional estimate of the compute window the fetch
      would hide behind (e.g. wave-0's estimated cost).  When provided
      and ≤ 0 there is nothing to overlap with, so the gate refuses.

    Like every cost decision this influences scheduling only.
    """
    if overlap_s is not None and overlap_s <= 0.0:
        return False
    if round_trip_s is None:
        return True
    return float(round_trip_s) >= PREFETCH_MIN_ROUND_TRIP_S


def fold_costs(record: Dict[str, Any], stats: Any) -> None:
    """Fold one run's measured per-node costs into ``record`` (the
    plan-manifest dict): update the fingerprint-keyed EWMA table and
    re-annotate every node's ``cost_act_s``.  Mutates ``record``.

    The EWMA tracks the cost to *recompute* a node per query.  For
    cached nodes the run's wall time is dominated by store round trips,
    so the raw miss-path compute channel
    (``PlanStats.node_compute_s`` / ``node_compute_queries``) is used
    instead — and an all-hit run, which recomputed nothing, contributes
    no observation at all rather than a near-zero one.  Uncached nodes
    fold their wall time over the run's query count as before."""
    nodes = record.get("nodes") or []
    fp_by_label = {n.get("label"): n.get("fingerprint") for n in nodes}
    n_queries = max(1, int(getattr(stats, "n_queries", 0) or 0))
    compute_s = getattr(stats, "node_compute_s", None) or {}
    compute_q = getattr(stats, "node_compute_queries", None) or {}
    model = CostModel.from_manifest(record)
    for label, total_s in (getattr(stats, "node_times_s", None) or {}).items():
        fp = fp_by_label.get(label)
        if not fp:
            continue
        if label in compute_q:           # cached node: raw recomputes only
            cq = int(compute_q.get(label, 0))
            raw_s = float(compute_s.get(label, 0.0))
            if cq > 0:
                model.observe(fp, raw_s / cq)
            # the remainder of the wrapper's wall time is the cache
            # path itself — what cache-place weighs recompute against
            model.observe_cache(fp, max(0.0, float(total_s) - raw_s)
                                / n_queries)
            continue
        model.observe(fp, float(total_s) / n_queries)
    record["costs"] = model.to_manifest()
    annotate_node_actuals(record, model)


def annotate_node_actuals(record: Dict[str, Any],
                          model: Optional[CostModel] = None) -> None:
    """Set each node dict's ``cost_act_s`` from the manifest's measured
    EWMA table — what explain()'s est-vs-actual columns render."""
    if model is None:
        model = CostModel.from_manifest(record)
    for n in record.get("nodes") or []:
        act = model.measured_cost(n.get("fingerprint"))
        if act is not None:
            n["cost_act_s"] = _round_cost(act)
