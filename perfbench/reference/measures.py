"""nDCG@k and average precision, as trec_eval defines them, in plain Python.

``ranked`` is a topic's docnos in rank order, ``labels`` its graded
judgements (label > 0 is relevant).  nDCG's gain is ``2**label - 1`` with
a ``log2(rank + 1)`` discount, normalised by the ideal ordering of the
judged labels; AP divides by the number of relevant passages judged.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

__all__ = ["ndcg", "average_precision"]


def ndcg(ranked: Sequence[str], labels: Dict[str, int], k: int) -> float:
    dcg = sum((2.0 ** labels.get(d, 0) - 1.0) / math.log2(i + 2.0)
              for i, d in enumerate(ranked[:k]))
    ideal = sorted(labels.values(), reverse=True)[:k]
    idcg = sum((2.0 ** g - 1.0) / math.log2(i + 2.0)
               for i, g in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def average_precision(ranked: Sequence[str], labels: Dict[str, int]) -> float:
    n_rel = sum(1 for v in labels.values() if v > 0)
    if n_rel == 0:
        return 0.0
    hits, total = 0, 0.0
    for i, d in enumerate(ranked):
        if labels.get(d, 0) > 0:
            hits += 1
            total += hits / (i + 1.0)
    return total / n_rel
