"""IR evaluation measures over R (results) × RA (qrels) relations.

Counterpart of ``repro.core.measures``, copied: it is numpy only.

Pure-numpy implementations of the standard measures the paper's
``Experiment`` abstraction computes (nDCG@k, MAP, MRR, P@k, R@k,
Judged@k).  Per-query values are returned so the experiment layer can
run significance tests.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .frame import ColFrame

__all__ = ["Measure", "parse_measure", "evaluate", "MEASURES"]


class Measure:
    """A named per-query measure."""

    def __init__(self, name: str, fn: Callable, k: Optional[int] = None):
        self.name = name
        self.fn = fn
        self.k = k

    def __repr__(self):
        return self.name

    def __eq__(self, other):
        return str(other) == self.name

    def __hash__(self):
        return hash(self.name)

    def per_query(self, ranked_docnos: Sequence[str],
                  rels: Mapping[str, float]) -> float:
        return self.fn(ranked_docnos, rels, self.k)


# -- measure bodies ----------------------------------------------------------
# `ranked` = docnos in rank order; `rels` = docno -> graded label (>0 = rel)

def _ndcg(ranked, rels, k):
    k = k or len(ranked)
    gains = [rels.get(d, 0.0) for d in ranked[:k]]
    dcg = sum((2.0 ** g - 1.0) / math.log2(i + 2.0) for i, g in enumerate(gains))
    ideal = sorted(rels.values(), reverse=True)[:k]
    idcg = sum((2.0 ** g - 1.0) / math.log2(i + 2.0) for i, g in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def _ap(ranked, rels, k):
    k = k or len(ranked)
    n_rel = sum(1 for v in rels.values() if v > 0)
    if n_rel == 0:
        return 0.0
    hits, s = 0, 0.0
    for i, d in enumerate(ranked[:k]):
        if rels.get(d, 0.0) > 0:
            hits += 1
            s += hits / (i + 1.0)
    return s / n_rel


def _rr(ranked, rels, k):
    k = k or len(ranked)
    for i, d in enumerate(ranked[:k]):
        if rels.get(d, 0.0) > 0:
            return 1.0 / (i + 1.0)
    return 0.0


def _precision(ranked, rels, k):
    k = k or len(ranked)
    if k == 0:
        return 0.0
    return sum(1.0 for d in ranked[:k] if rels.get(d, 0.0) > 0) / float(k)


def _recall(ranked, rels, k):
    k = k or len(ranked)
    n_rel = sum(1 for v in rels.values() if v > 0)
    if n_rel == 0:
        return 0.0
    return sum(1.0 for d in ranked[:k] if rels.get(d, 0.0) > 0) / float(n_rel)


def _judged(ranked, rels, k):
    k = k or len(ranked)
    if k == 0:
        return 0.0
    return sum(1.0 for d in ranked[:k] if d in rels) / float(min(k, max(len(ranked), 1)))


_BASE: Dict[str, Callable] = {
    "nDCG": _ndcg, "AP": _ap, "MAP": _ap, "RR": _rr, "MRR": _rr,
    "P": _precision, "R": _recall, "Recall": _recall, "Judged": _judged,
}

MEASURES = sorted(_BASE)

_MEASURE_RE = re.compile(r"^([A-Za-z]+)(?:@(\d+))?$")


def parse_measure(spec) -> Measure:
    """Parse 'nDCG@10', 'MAP', 'P@5', … into a Measure."""
    if isinstance(spec, Measure):
        return spec
    m = _MEASURE_RE.match(str(spec))
    if not m or m.group(1) not in _BASE:
        raise ValueError(f"unknown measure {spec!r}; known: {MEASURES}")
    name, k = m.group(1), m.group(2)
    return Measure(str(spec), _BASE[name], int(k) if k else None)


# ---------------------------------------------------------------------------

def _qrels_maps(qrels: ColFrame) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    qid_col = qrels["qid"].tolist()
    doc_col = qrels["docno"].tolist()
    lab_col = qrels["label"].tolist()
    for q, d, l in zip(qid_col, doc_col, lab_col):
        out.setdefault(str(q), {})[str(d)] = float(l)
    return out


def evaluate(results: ColFrame, qrels: ColFrame,
             measures: Sequence) -> Dict[str, Dict[str, float]]:
    """measure-name -> {qid -> value}.  Queries present in qrels but
    retrieved nothing score 0 (trec_eval convention)."""
    measures = [parse_measure(m) for m in measures]
    rel_map = _qrels_maps(qrels)
    per_q: Dict[str, Dict[str, float]] = {m.name: {} for m in measures}

    ranked_by_q: Dict[str, List[str]] = {q: [] for q in rel_map}
    if len(results):
        res = results.sort_values(["qid", "rank"]) if "rank" in results else \
            results.sort_values(["qid", "score"], ascending=[True, False])
        for q, d in zip(res["qid"].tolist(), res["docno"].tolist()):
            q = str(q)
            if q in ranked_by_q:
                ranked_by_q[q].append(str(d))

    for qid, rels in rel_map.items():
        ranked = ranked_by_q.get(qid, [])
        for m in measures:
            per_q[m.name][qid] = m.per_query(ranked, rels)
    return per_q
