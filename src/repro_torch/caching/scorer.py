"""ScorerCache — caching pointwise scorer/reranker results (paper §4.2).

Counterpart of ``repro.caching.scorer``.

Pointwise scorers assign each document a new score independently (the
probability ranking principle), so ``(query, docno) → score`` caching is
sound.  After merging cached + fresh scores the rank column is
re-assigned.  The key/value columns can be overridden (e.g.
``("qid","docno","query","text")`` to be robust to query/text rewriting,
exactly as §2.1 discusses).

Not applicable to pairwise/listwise scorers (DuoT5) or adaptive
rerankers — their scores depend on the candidate pool; such transformers
carry ``cacheable=False`` and ``auto_cache`` refuses to wrap them.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..core.frame import ColFrame
from ..core.pipeline import add_ranks
from .kv import KeyValueCache

__all__ = ["ScorerCache"]


class ScorerCache(KeyValueCache):
    """(query, docno) → score cache with rank re-assignment."""

    def __init__(self, path: Optional[str] = None, transformer: Any = None,
                 *, key: Any = ("query", "docno"), value: Any = ("score",),
                 verify_fraction: float = 0.0, backend: Any = None,
                 fingerprint: Optional[str] = None, on_stale: str = "error",
                 budget: Any = None,
                 async_writes: Optional[bool] = None):
        super().__init__(path, transformer, key=key, value=value,
                         verify_fraction=verify_fraction, backend=backend,
                         fingerprint=fingerprint, on_stale=on_stale,
                         budget=budget, async_writes=async_writes)

    # Doc-keyed: ``docno`` only exists once the upstream retriever has
    # produced its candidates, so the executors prefetch this cache the
    # moment that node completes (overlapping sibling-branch work)
    # rather than at submit time — ``prefetch_columns`` says so by
    # naming columns the source frame does not carry.  The inherited
    # all-float fast path decodes a warm score batch with one
    # ``frombuffer`` (the packed ``kv-fnv128-pack1`` value codec).

    def transform(self, inp: ColFrame) -> ColFrame:
        if len(inp) == 0:
            return inp
        out = super().transform(inp)
        score = np.asarray(out["score"], dtype=np.float64)
        out = out.assign(score=score)
        return add_ranks(out)
