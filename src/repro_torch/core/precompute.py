"""Prefix precomputation for comparative experiments (paper §3).

Counterpart of ``repro.core.precompute``, copied.

The paper's contribution: when ``Experiment()`` evaluates a set of
pipelines ``P = {p_1 … p_M}``, identify the longest common prefix

    LCP(P) = argmax_cp { ||cp||  s.t.  cp[j] == p_i[j]  ∀ i, 1…j }   (Eq. 2)

execute it once on the queries, and feed the interim results into each
*remainder* pipeline ``p̂_i = p_i[||LCP(P)|| .. ||p_i||]``.  The only
requirement placed on transformers is an equality property — provided
structurally by ``Transformer.signature()``.

Beyond the paper (its §6 names this as an open limitation): the LCP
misses prefixes shared by only a *subset* of pipelines, e.g. the
ablation ``A;  A»B;  A»B»C`` only precomputes ``A`` even though ``A»B``
is shared by two pipelines.  ``PrefixTrie`` executes each shared trie
node exactly once, which strictly dominates LCP (and degenerates to LCP
when every prefix is common to all pipelines).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .frame import ColFrame
from .pipeline import Compose, Identity, Transformer, stages_of

__all__ = [
    "longest_common_prefix", "split_on_prefix", "run_with_precompute",
    "PrefixTrie", "run_with_trie", "PrecomputeStats",
]


# ---------------------------------------------------------------------------
# LCP (paper §3, Eq. 2)
# ---------------------------------------------------------------------------

def longest_common_prefix(
        pipelines: Sequence[Transformer]) -> Tuple[Transformer, ...]:
    """The longest common prefix of the stage decompositions (Eq. 2).

    Only assumes stage equality (``==`` via structural signatures).
    Returns a (possibly empty) tuple of stages.
    """
    if not pipelines:
        return ()
    stage_lists = [stages_of(p) for p in pipelines]
    limit = min(len(s) for s in stage_lists)
    prefix: List[Transformer] = []
    for j in range(limit):
        first = stage_lists[0][j]
        if all(sl[j] == first for sl in stage_lists[1:]):
            prefix.append(first)
        else:
            break
    return tuple(prefix)


def split_on_prefix(pipeline: Transformer,
                    prefix_len: int) -> Transformer:
    """The remainder pipeline  p̂ = p[prefix_len .. ||p||]."""
    stages = stages_of(pipeline)
    rest = stages[prefix_len:]
    if not rest:
        return Identity()
    if len(rest) == 1:
        return rest[0]
    return Compose(rest)


@dataclass
class PrecomputeStats:
    """Accounting for how much work precomputation avoided."""
    prefix_len: int = 0
    n_pipelines: int = 0
    stage_invocations_saved: int = 0     # (#pipelines-1) × prefix_len (LCP)
    nodes_executed: int = 0              # trie mode: executed trie nodes
    nodes_total: int = 0                 # trie mode: Σ stages over pipelines


def run_with_precompute(
        pipelines: Sequence[Transformer],
        queries: ColFrame,
        *,
        batch_size: Optional[int] = None,
        n_shards: Optional[int] = None,
        max_workers: Optional[int] = None,
) -> Tuple[List[ColFrame], PrecomputeStats]:
    """Execute pipelines over `queries` sharing the LCP exactly once.

    Mirrors the semantics of running each pipeline independently (the
    cache-transparency invariant is asserted in tests).

    Thin wrapper over ``plan.ExecutionPlan`` (which shares strictly more
    than the LCP); the returned stats keep the paper-§3 accounting —
    ``stage_invocations_saved`` is the Eq. 2 quantity
    ``(|P|-1) × ||LCP(P)||`` — so callers comparing against the paper's
    tables see the LCP numbers.
    """
    from .plan import ExecutionPlan

    prefix = longest_common_prefix(pipelines)
    outs, plan_stats = ExecutionPlan(pipelines).run(
        queries, batch_size=batch_size, n_shards=n_shards,
        max_workers=max_workers)
    stats = PrecomputeStats(
        prefix_len=len(prefix), n_pipelines=len(pipelines),
        stage_invocations_saved=max(0, (len(pipelines) - 1)) * len(prefix),
        nodes_executed=plan_stats.nodes_executed,
        nodes_total=plan_stats.nodes_total)
    return outs, stats


def _run_stage(stage: Transformer, inp: ColFrame,
               batch_size: Optional[int]) -> ColFrame:
    if batch_size is None or len(inp) <= batch_size:
        return stage(inp)
    parts = []
    for lo in range(0, len(inp), batch_size):
        parts.append(stage(inp.take(range(lo, min(lo + batch_size, len(inp))))))
    return ColFrame.concat(parts)


# ---------------------------------------------------------------------------
# Beyond-paper: maximal-coverage prefix trie (§6 limitation resolved)
# ---------------------------------------------------------------------------

@dataclass
class _TrieNode:
    stage: Optional[Transformer] = None
    children: Dict[Tuple, "_TrieNode"] = field(default_factory=dict)
    #: indices of pipelines that *terminate* at this node
    terminal: List[int] = field(default_factory=list)

    def child(self, stage: Transformer) -> "_TrieNode":
        key = stage.signature()
        node = self.children.get(key)
        if node is None:
            node = _TrieNode(stage=stage)
            self.children[key] = node
        return node


class PrefixTrie:
    """A prefix trie over pipeline stage decompositions.

    Each node is executed at most once per ``run``; every pipeline
    re-uses every shared ancestor, not just the global LCP.  For the
    paper's §6 ablation case ``A; A»B; A»B»C`` the trie executes A once
    and B once (LCP executes A once but B twice).
    """

    def __init__(self, pipelines: Sequence[Transformer]):
        self.pipelines = list(pipelines)
        self.root = _TrieNode()
        for i, p in enumerate(self.pipelines):
            node = self.root
            for stage in stages_of(p):
                node = node.child(stage)
            node.terminal.append(i)

    # -- analysis ---------------------------------------------------------
    def n_nodes(self) -> int:
        count = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            count += len(node.children)
            stack.extend(node.children.values())
        return count

    def n_stage_invocations_naive(self) -> int:
        return sum(len(stages_of(p)) for p in self.pipelines)

    # -- execution ----------------------------------------------------------
    def run(self, queries: ColFrame,
            batch_size: Optional[int] = None,
            ) -> Tuple[List[ColFrame], PrecomputeStats]:
        outs: List[Optional[ColFrame]] = [None] * len(self.pipelines)
        executed = 0

        def visit(node: _TrieNode, interim: ColFrame):
            nonlocal executed
            for i in node.terminal:
                outs[i] = interim
            for child in node.children.values():
                res = _run_stage(child.stage, interim, batch_size)
                executed += 1
                visit(child, res)

        visit(self.root, queries)
        stats = PrecomputeStats(
            prefix_len=len(longest_common_prefix(self.pipelines)),
            n_pipelines=len(self.pipelines),
            nodes_executed=executed,
            nodes_total=self.n_stage_invocations_naive(),
            stage_invocations_saved=self.n_stage_invocations_naive() - executed,
        )
        return [o if o is not None else ColFrame() for o in outs], stats


def run_with_trie(pipelines: Sequence[Transformer], queries: ColFrame,
                  *, batch_size: Optional[int] = None,
                  n_shards: Optional[int] = None,
                  max_workers: Optional[int] = None,
                  ) -> Tuple[List[ColFrame], PrecomputeStats]:
    """Maximal-coverage sharing — thin wrapper over ``plan.ExecutionPlan``,
    which subsumes the trie (and additionally shares through binary
    operator nodes; ``PrefixTrie`` is kept for structural analysis)."""
    from .plan import ExecutionPlan

    return ExecutionPlan(pipelines).run(queries, batch_size=batch_size,
                                        n_shards=n_shards,
                                        max_workers=max_workers)
