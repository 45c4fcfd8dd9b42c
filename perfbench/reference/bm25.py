"""Plain NumPy BM25 over the benchmark's corpus, from its term ids.

``score = sum over query words t of idf(t) * tf * (k1 + 1) /
(tf + k1 * (1 - b + b * dl / avg_dl))`` with ``idf(t) = ln(1 + (N - df +
0.5) / (df + 0.5))``, a repeated query word counted each time, in
float64.  The top ``k`` are the passages with a positive score, by score
and then by passage index.
"""
from __future__ import annotations

import re
from typing import Tuple

import numpy as np

__all__ = ["BM25"]


class BM25:
    def __init__(self, terms: np.ndarray, offsets: np.ndarray, vocab: int,
                 k1: float = 1.2, b: float = 0.75):
        self.n_docs = len(offsets) - 1
        self.dl = np.diff(offsets).astype(np.float64)
        self.norm = k1 * (1.0 - b + b * self.dl / self.dl.mean())
        self.k1 = k1
        doc_of = np.repeat(np.arange(self.n_docs, dtype=np.int64),
                           np.diff(offsets))
        order = np.argsort(terms, kind="stable")
        self._docs = doc_of[order]
        self._starts = np.searchsorted(terms[order], np.arange(vocab + 1))
        self._word_ids = {f"w{i}": i for i in range(vocab)}

    def _postings(self, word: str) -> Tuple[np.ndarray, np.ndarray]:
        t = self._word_ids.get(word)
        if t is None:
            return np.zeros(0, np.int64), np.zeros(0)
        docs = self._docs[self._starts[t]:self._starts[t + 1]]
        ids, tf = np.unique(docs, return_counts=True)
        return ids, tf.astype(np.float64)

    def scores(self, query: str) -> np.ndarray:
        acc = np.zeros(self.n_docs)
        for word in re.findall(r"[a-z0-9]+", query.lower()):
            ids, tf = self._postings(word)
            df = len(ids)
            idf = np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5))
            acc[ids] += idf * tf * (self.k1 + 1.0) / (tf + self.norm[ids])
        return acc

    def top(self, query: str, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(passage indices, scores) of the top ``k``, and every score."""
        acc = self.scores(query)
        nz = np.nonzero(acc > 0)[0]
        order = np.lexsort((nz, -acc[nz]))[:k]
        return nz[order], acc
