"""MS MARCO v1 passage-shaped synthetic corpus, topics and graded qrels.

The generator follows ``make_corpus`` of the port's ``ir/corpus.py``
(a frozen copy of its distribution, drawn in bulk with numpy so that a
200,000-passage corpus takes seconds instead of a quarter of a minute):

* a vocabulary of ``vocab`` words ``w0 .. w{vocab-1}``;
* passage lengths uniform in ``doc_len`` (inclusive), terms drawn from
  a Zipf(``zipf_s``) law over word ranks, truncated to the vocabulary;
* each topic owns ``topic_terms`` distinct mid-frequency words (ranks
  50 .. vocab/2); ``rels_per_topic`` passages per topic are planted with
  3 to 8 extra draws from those words, and the planted passages carry
  graded labels 3, 3, 3, 2, 2, 2, 1, 1;
* a query is ``query_terms`` distinct words of its topic's set.

The term ids of every passage are kept (``terms``, ``offsets``) so that
the reference can build its own index without tokenising the texts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

__all__ = ["Corpus", "make_corpus"]


@dataclass
class Corpus:
    docnos: List[str]
    texts: List[str]
    terms: np.ndarray          # int32, every passage's term ids, concatenated
    offsets: np.ndarray        # int64 [n_docs + 1]
    qids: List[str]
    queries: List[str]
    query_terms: np.ndarray    # int32 [n_topics, query_terms]
    qrels: Dict[str, Dict[str, int]]   # qid -> docno -> label
    vocab: int

    @property
    def n_docs(self) -> int:
        return len(self.docnos)

    def text_map(self) -> Dict[str, str]:
        return dict(zip(self.docnos, self.texts))


def _distinct_rows(rng: np.random.Generator, n_rows: int, k: int,
                   lo: int, hi: int) -> np.ndarray:
    """[n_rows, k] distinct integers in [lo, hi) per row."""
    out = np.empty((n_rows, k), dtype=np.int64)
    for a in range(0, n_rows, 512):
        b = min(a + 512, n_rows)
        keys = rng.random((b - a, hi - lo))
        out[a:b] = np.argpartition(keys, k, axis=1)[:, :k] + lo
    return out


def _zipf_ranks(rng: np.random.Generator, s: float, vocab: int,
                n: int) -> np.ndarray:
    """``min(rng.zipf(s) - 1, vocab - 1)`` in law, by inverse CDF: the
    ranks at and beyond ``vocab`` all land on the last word."""
    k = np.arange(1, vocab, dtype=np.float64)
    big = 100_000                                # zeta(s) by Euler-Maclaurin
    head = np.arange(1, big, dtype=np.float64) ** -s
    zeta = head.sum() + big ** (1 - s) / (s - 1) + big ** -s / 2 \
        + s * big ** (-s - 1) / 12
    cdf = np.cumsum(k ** -s) / zeta
    return np.searchsorted(cdf, rng.random(n), side="right")


def make_corpus(name: str, *, n_docs: int, n_topics: int, seed: int,
                vocab: int = 5000, doc_len=(30, 80), zipf_s: float = 1.1,
                rels_per_topic: int = 8, topic_terms: int = 6,
                query_terms: int = 3) -> Corpus:
    rng = np.random.default_rng(seed)
    topics = _distinct_rows(rng, n_topics, topic_terms, 50, vocab // 2)

    # planted passages: distinct within a topic
    planted = rng.integers(0, n_docs, size=(n_topics, rels_per_topic))
    for q in range(n_topics):
        while len(set(planted[q].tolist())) < rels_per_topic:
            planted[q] = rng.choice(n_docs, size=rels_per_topic,
                                    replace=False)

    lengths = rng.integers(doc_len[0], doc_len[1] + 1, size=n_docs)
    zipf = _zipf_ranks(rng, zipf_s, vocab, int(lengths.sum()))
    zipf_doc = np.repeat(np.arange(n_docs), lengths)

    boosts = rng.integers(3, 9, size=n_topics * rels_per_topic)
    plant_doc = np.repeat(planted.reshape(-1), boosts)
    plant_topic = np.repeat(np.repeat(np.arange(n_topics), rels_per_topic),
                            boosts)
    plant_terms = topics[plant_topic,
                         rng.integers(0, topic_terms, size=len(plant_doc))]

    doc = np.concatenate([zipf_doc, plant_doc])
    term = np.concatenate([zipf, plant_terms])
    # grouped by passage, shuffled within it
    order = np.argsort(doc + rng.random(len(doc)))
    terms = term[order].astype(np.int32)
    counts = np.bincount(doc, minlength=n_docs)
    offsets = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])

    words = np.array([f"w{i}" for i in range(vocab)], dtype=object)
    toks = words[terms]
    ends = offsets[1:] - 1
    toks[ends] = [w + "\n" for w in toks[ends]]
    texts = " ".join(toks.tolist()).split("\n")[:n_docs]
    texts = [t.strip() for t in texts]

    sel = np.argsort(rng.random((n_topics, topic_terms)),
                     axis=1)[:, :query_terms]
    qterms = np.take_along_axis(topics, sel, axis=1).astype(np.int32)
    queries = [" ".join(words[t] for t in row) for row in qterms]

    docnos = [f"{name}_d{i}" for i in range(n_docs)]
    qids = [f"{name}_q{j}" for j in range(n_topics)]
    labels = [3 - min(r // 3, 2) for r in range(rels_per_topic)]
    qrels = {qids[q]: {docnos[d]: labels[r]
                       for r, d in enumerate(planted[q].tolist())}
             for q in range(n_topics)}
    return Corpus(docnos=docnos, texts=texts, terms=terms, offsets=offsets,
                  qids=qids, queries=queries, query_terms=qterms,
                  qrels=qrels, vocab=vocab)
