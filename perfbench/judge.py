"""The comparison that decides ``correct``: the program's outputs, judged
against the plain reference (``perfbench.reference``).

The judge reads what the timed path returned (BM25's rankings, the
scores the ScorerCache returned on hits and misses, each system's final
ranking and measures, each served request's reranked list) as plain
Python, and works every number out again from the benchmark's corpus and
weights.  The numbers:

* ``bm25_score_gap``: the widest gap between a passage's BM25 score in
  the program and in the reference, over the topic's best reference
  score;
* ``bm25_rank_faults``: returned lists of the wrong length, passages
  below the reference's k-th score, and neighbours out of the reference's
  order, each by more than the gap's limit;
* ``mono_gap``: the widest gap between a pair's Mono score in the program
  and in the reference, over the spread (standard deviation) of the
  reference's scores of that topic's pairs;
* ``mono_cut_faults``: passages a system sent on past ``mono % 10`` whose
  reference score lies below the reference's 10th best by more than the
  gap's limit, or that the reference's BM25 never returned;
* ``duo_gap``: as ``mono_gap``, for Duo's aggregated scores over the
  passages the program sent to Duo;
* ``final_rank_faults``: neighbours in the program's final ranking out of
  the reference's order by more than the gap's limit, and served lists
  that are not the passages BM25 returned for them;
* ``measure_gap``: the widest gap between the program's nDCG@10 or AP of
  a topic and the reference's, computed over the program's final ranking;
* ``missing``: requests that failed or never came back.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .reference.bm25 import BM25
from .reference.encoder import score_pairs
from .reference.measures import average_precision, ndcg
from .reference.tokens import pair_ids

__all__ = ["Judge"]


def _spread(values) -> float:
    v = np.asarray(list(values), dtype=np.float64)
    return float(v.std()) if v.size > 1 and v.std() > 0 else 1.0


class Judge:
    def __init__(self, corpus, cfg: Dict, weights: Dict[str, Dict],
                 limits: Dict[str, float]):
        self.corpus = corpus
        self.vocab = cfg["vocab_size"]
        self.max_len = cfg["max_position_embeddings"]
        self.weights = weights
        self.limits = limits
        self.bm25 = BM25(corpus.terms, corpus.offsets, corpus.vocab)
        self.doc_index = {d: i for i, d in enumerate(corpus.docnos)}
        self._memo: Dict[str, int] = {}
        self._bm25_top: Dict[Tuple[str, int], Tuple] = {}

    # -- reference pieces ----------------------------------------------------
    def _top(self, query: str, k: int):
        key = (query, k)
        if key not in self._bm25_top:
            self._bm25_top[key] = self.bm25.top(query, k)
        return self._bm25_top[key]

    def _score(self, model: str, pairs: Sequence[Tuple[str, str]]
               ) -> np.ndarray:
        ids = [pair_ids(q, t, self.vocab, self.max_len, self._memo)
               for q, t in pairs]
        return score_pairs(self.weights[model], ids)

    def _text(self, docno: str) -> str:
        return self.corpus.texts[self.doc_index[docno]]

    # -- BM25 ----------------------------------------------------------------
    def bm25_numbers(self, query: str, k: int, rows: List) -> Tuple[float,
                                                                    int]:
        """(score gap, faults) of one returned BM25 list ``rows``
        (docno, score, rank) in rank order."""
        tol = self.limits["bm25_score_gap"]
        top, acc = self._top(query, k)
        scale = acc[top[0]] if len(top) else 1.0
        faults = int(len(rows) != len(top))
        gap = 0.0
        kth = acc[top[-1]] if len(top) else 0.0
        prev = None
        for docno, score, _ in rows:
            i = self.doc_index.get(docno)
            if i is None:
                faults += 1
                continue
            gap = max(gap, abs(score - acc[i]) / scale)
            if acc[i] < kth - tol * scale:
                faults += 1
            if prev is not None and acc[i] > prev + tol * scale:
                faults += 1
            prev = acc[i]
        return gap, faults

    # -- Table 2 Experiments -------------------------------------------------
    def experiment(self, sample: List[Dict], cuts: Sequence[int],
                   bm25_out: List[Dict], cache_out: List[Dict]
                   ) -> Dict[str, float]:
        """``sample``: one dict per topic judged, with ``qid``, ``query``,
        ``final`` (one ranking per system) and ``measures`` (per system:
        name -> value)."""
        k_max = max(cuts)
        bm25_rows = defaultdict(list)
        for out in bm25_out:
            for q, rows in out.items():
                bm25_rows[q].append(rows)
        cache_rows = defaultdict(list)
        for out in cache_out:
            for q, rows in out.items():
                cache_rows[q].extend(rows)

        n = dict(bm25_score_gap=0.0, bm25_rank_faults=0, mono_gap=0.0,
                 mono_cut_faults=0, duo_gap=0.0, final_rank_faults=0,
                 measure_gap=0.0)
        mono_pairs, duo_pairs = {}, {}
        for t in sample:
            q, query = t["qid"], t["query"]
            got = bm25_rows.get(q, [])
            if not got:
                n["bm25_rank_faults"] += 1
            for rows in got:
                gap, faults = self.bm25_numbers(query, k_max, rows)
                n["bm25_score_gap"] = max(n["bm25_score_gap"], gap)
                n["bm25_rank_faults"] += faults
            top, _ = self._top(query, k_max)
            docs = {self.corpus.docnos[i] for i in top}
            docs |= {d for d, _, _ in cache_rows.get(q, [])}
            for d in docs:
                mono_pairs[(q, d)] = (query, self._text(d))
            for final in t["final"]:
                ranked = [d for d, _, _ in final]
                for a in ranked:
                    for b in ranked:
                        if a != b:
                            duo_pairs[(q, a, b)] = (
                                query, self._text(a) + " [VS] "
                                + self._text(b))
        mono = dict(zip(mono_pairs, self._score("mono",
                                                list(mono_pairs.values()))))
        duo = dict(zip(duo_pairs, self._score("duo",
                                              list(duo_pairs.values()))))

        tol_m, tol_d = self.limits["mono_gap"], self.limits["duo_gap"]
        for t in sample:
            q, query = t["qid"], t["query"]
            ref = {d: s for (qq, d), s in mono.items() if qq == q}
            spread = _spread(ref.values())
            for d, s, _ in cache_rows.get(q, []):
                n["mono_gap"] = max(n["mono_gap"], abs(s - ref[d]) / spread)
            if not cache_rows.get(q):
                n["mono_cut_faults"] += 1
            for k, final, measures in zip(cuts, t["final"], t["measures"]):
                top, _ = self._top(query, k)
                cand = sorted((ref[self.corpus.docnos[i]] for i in top),
                              reverse=True)
                tenth = cand[min(len(final), len(cand)) - 1] if cand else 0.0
                allowed = {self.corpus.docnos[i] for i in top}
                ranked = [d for d, _, _ in final]
                for d in ranked:
                    if d not in allowed or d not in ref \
                            or ref[d] < tenth - tol_m * spread:
                        n["mono_cut_faults"] += 1
                agg = {d: 0.0 for d in ranked}
                for a in ranked:
                    for b in ranked:
                        if a != b:
                            v = duo[(q, a, b)]
                            agg[a] += v
                            agg[b] -= v
                dspread = _spread(agg.values())
                for d, s, _ in final:
                    n["duo_gap"] = max(n["duo_gap"],
                                       abs(s - agg[d]) / dspread)
                for a, b in zip(ranked, ranked[1:]):
                    if agg[b] > agg[a] + tol_d * dspread:
                        n["final_rank_faults"] += 1
                labels = self.corpus.qrels[q]
                ref_m = {"nDCG@10": ndcg(ranked, labels, 10),
                         "MAP": average_precision(ranked, labels)}
                for name, v in measures.items():
                    n["measure_gap"] = max(n["measure_gap"],
                                           abs(v - ref_m[name]))
        return n

    # -- served requests -----------------------------------------------------
    def serving(self, sample: List[Dict], depth: int,
                bm25_out: List[Dict], missing: int) -> Dict[str, float]:
        """``sample``: one dict per request judged, with ``qid``,
        ``query`` and ``rows`` (docno, score, rank) in rank order."""
        bm25_rows = defaultdict(list)
        for out in bm25_out:
            for q, rows in out.items():
                bm25_rows[q].append(rows)
        n = dict(bm25_score_gap=0.0, bm25_rank_faults=0, mono_gap=0.0,
                 final_rank_faults=0, missing=missing)
        pairs = {}
        for r in sample:
            q = r["qid"]
            got = bm25_rows.get(q, [])
            if not got:
                n["bm25_rank_faults"] += 1
            for rows in got:
                gap, faults = self.bm25_numbers(r["query"], depth, rows)
                n["bm25_score_gap"] = max(n["bm25_score_gap"], gap)
                n["bm25_rank_faults"] += faults
            for d, _, _ in r["rows"]:
                pairs[(q, d)] = (r["query"], self._text(d))
        ref = dict(zip(pairs, self._score("mono", list(pairs.values()))))
        tol = self.limits["mono_gap"]
        for r in sample:
            q = r["qid"]
            retrieved = bm25_rows.get(q, [[]])[0]
            if {d for d, _, _ in r["rows"]} != {d for d, _, _ in retrieved}:
                n["final_rank_faults"] += 1
            scores = {d: ref[(q, d)] for d, _, _ in r["rows"]}
            spread = _spread(scores.values())
            for d, s, _ in r["rows"]:
                n["mono_gap"] = max(n["mono_gap"],
                                    abs(s - scores[d]) / spread)
            ranked = [d for d, _, _ in r["rows"]]
            for a, b in zip(ranked, ranked[1:]):
                if scores[b] > scores[a] + tol * spread:
                    n["final_rank_faults"] += 1
        return n
