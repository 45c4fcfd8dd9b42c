"""Synthetic corpora + topics + qrels at controlled scales.

Counterpart of ``repro.ir.corpus``, copied: it is numpy only.

MSMARCO v1/v2 are not available offline, so the demonstration
experiments (paper §5, Table 2) run on synthetic Zipfian corpora whose
*relative* scales match (v2 ≈ 4.4× v1 documents; 43 vs 53 queries).
Documents are drawn from a Zipf-distributed vocabulary; each query is
seeded from a "topic" term set so BM25 produces non-degenerate rankings
and qrels are planted with graded labels.

Everything is deterministic given the seed — a property the caching
layer's verification mode relies on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.frame import ColFrame

__all__ = ["SyntheticCorpus", "make_corpus", "msmarco_like"]


@dataclass
class SyntheticCorpus:
    """A corpus + topic set + graded qrels."""
    name: str
    docs: ColFrame        # D(docno, text)
    topics: ColFrame      # Q(qid, query)
    qrels: ColFrame       # RA(qid, docno, label)

    def get_corpus_iter(self) -> Iterator[dict]:
        for row in self.docs.to_dicts():
            yield row

    def get_topics(self) -> ColFrame:
        return self.topics

    def get_qrels(self) -> ColFrame:
        return self.qrels

    def text_map(self) -> Dict[str, str]:
        return dict(zip(self.docs["docno"].tolist(),
                        self.docs["text"].tolist()))


def _zipf_terms(rng: np.random.Generator, vocab: int, n: int) -> np.ndarray:
    # Zipf(s≈1.1) truncated to the vocabulary, 0-indexed term ids.
    ranks = rng.zipf(1.1, size=n)
    return np.minimum(ranks - 1, vocab - 1)


def make_corpus(name: str, *, n_docs: int, n_queries: int,
                vocab: int = 5000, doc_len: Tuple[int, int] = (30, 80),
                rels_per_query: int = 8, seed: int = 0) -> SyntheticCorpus:
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(vocab)], dtype=object)

    # topic nuclei: distinct mid-frequency term groups per query
    topic_terms = rng.choice(np.arange(50, vocab // 2), size=(n_queries, 6),
                             replace=False if n_queries * 6 < vocab // 2 - 50
                             else True)

    docnos = np.array([f"{name}_d{i}" for i in range(n_docs)], dtype=object)
    texts = np.empty(n_docs, dtype=object)
    lengths = rng.integers(doc_len[0], doc_len[1] + 1, size=n_docs)

    # plant relevant docs: for query q, docs q*rels..q*rels+rels are seeded
    planted: Dict[int, List[int]] = {}
    for q in range(n_queries):
        ids = rng.choice(n_docs, size=rels_per_query, replace=False)
        planted[q] = list(ids)

    plant_for_doc: Dict[int, List[int]] = {}
    for q, ids in planted.items():
        for d in ids:
            plant_for_doc.setdefault(d, []).append(q)

    for i in range(n_docs):
        terms = list(_zipf_terms(rng, vocab, lengths[i]))
        for q in plant_for_doc.get(i, []):
            boost = rng.integers(3, 9)
            terms.extend(rng.choice(topic_terms[q], size=boost).tolist())
        rng.shuffle(terms)
        texts[i] = " ".join(words[t] for t in terms)

    qids = np.array([f"{name}_q{j}" for j in range(n_queries)], dtype=object)
    queries = np.empty(n_queries, dtype=object)
    for q in range(n_queries):
        sel = rng.choice(topic_terms[q], size=3, replace=False)
        queries[q] = " ".join(words[t] for t in sel)

    rq, rd, rl = [], [], []
    for q, ids in planted.items():
        for rank_i, d in enumerate(ids):
            rq.append(str(qids[q]))
            rd.append(str(docnos[d]))
            rl.append(int(3 - min(rank_i // 3, 2)))   # graded 3/2/1
    qrels = ColFrame({"qid": rq, "docno": rd, "label": rl})

    return SyntheticCorpus(
        name=name,
        docs=ColFrame({"docno": docnos, "text": texts}),
        topics=ColFrame({"qid": qids, "query": queries}),
        qrels=qrels)


def msmarco_like(version: int = 1, scale: float = 1.0,
                 seed: int = 0) -> SyntheticCorpus:
    """Synthetic stand-ins for MSMARCO v1/v2 passage at reduced scale.

    Keeps the paper's *ratios*: v2 has ≈4.4× the documents of v1, and the
    TREC-DL 2019/2021 query counts (43 / 53).
    """
    if version == 1:
        return make_corpus("msv1", n_docs=int(9000 * scale), n_queries=43,
                           seed=seed)
    if version == 2:
        return make_corpus("msv2", n_docs=int(39600 * scale), n_queries=53,
                           seed=seed + 1)
    raise ValueError("version must be 1 or 2")
