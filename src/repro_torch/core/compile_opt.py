"""Pipeline compilation: conceptual -> logical rewriting (paper §3).

Counterpart of ``repro.core.compile_opt``, copied: it is plain Python.

The paper: "consider a transformer Retriever(index, k) that has a rank
cutoff operation (%k') applied.  A more efficient pipeline formulation
would be to apply the rank cutoff directly in the Retriever instance.
PyTerrier supports a number of such optional compile operations, which
allow applying a rewriting of the conceptual pipeline into a more
efficient logical variant — a syntactically different but semantically
equivalent reformulation that executes more quickly."  (Their footnote:
akin to SQL selection pushdown.)

Rewrites implemented (each semantics-preserving):

1. **cutoff pushdown** — ``Retriever(num_results=N) >> %k`` with k <= N
   becomes ``Retriever(num_results=k)`` (the retriever's own top-k
   pruning does less scoring/sorting work);
2. **cutoff fusion** — ``%k1 >> %k2`` becomes ``%min(k1,k2)``;
3. **identity elision** — ``Identity()`` stages are dropped;
4. **cutoff/rewrite reorder is NOT applied** across non-R->R stages
   (a cutoff cannot cross a stage that changes scores), mirroring the
   paper's caution that pipelines are affected by their leftmost
   constituent.

``compile_pipeline`` composes with prefix precomputation: Experiment
can compile each pipeline first and share the compiled prefixes.
"""
from __future__ import annotations

from typing import List, Optional

from .pipeline import Compose, Identity, RankCutoff, Transformer, stages_of

__all__ = ["compile_pipeline"]


def _clone_with_num_results(retriever, k: int):
    """Best-effort: retrievers expose num_results + a copy path."""
    import copy
    new = copy.copy(retriever)
    new.num_results = int(k)
    return new


def compile_pipeline(pipeline: Transformer) -> Transformer:
    """Rewrite a pipeline into an equivalent, cheaper logical plan."""
    stages = list(stages_of(pipeline))
    out: List[Transformer] = []
    for stage in stages:
        # 3. identity elision
        if isinstance(stage, Identity):
            continue
        if isinstance(stage, RankCutoff) and out:
            prev = out[-1]
            # 2. cutoff fusion
            if isinstance(prev, RankCutoff):
                out[-1] = RankCutoff(min(prev.k, stage.k))
                continue
            # 1. cutoff pushdown into a retriever
            if hasattr(prev, "num_results") and \
                    getattr(prev, "one_to_many", False) and \
                    stage.k <= prev.num_results:
                out[-1] = _clone_with_num_results(prev, stage.k)
                continue
        out.append(stage)
    if not out:
        return Identity()
    if len(out) == 1:
        return out[0]
    return Compose(out)
