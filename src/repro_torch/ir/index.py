"""Inverted index + BM25 first-stage retrieval (Q → R).

The index is a plain term→postings map (doc ids + term frequencies in
numpy arrays).  Scoring walks the query-term postings and accumulates
BM25 into a dense per-doc array — the standard TAAT strategy, vectorized
per term.  Counterpart of ``repro.ir.index``, with the same host loop
and boundary-tie rule, so rankings are identical per qid.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..core.frame import ColFrame
from ..core.pipeline import Indexer, Transformer, add_ranks
from .tokenizer import WordTokenizer

__all__ = ["InvertedIndex", "BM25Retriever", "TextLoader", "QueryExpander"]


class InvertedIndex:
    """Term → (doc_ids int32[], tf float32[]) postings."""

    def __init__(self):
        self.postings: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self.doc_len: Optional[np.ndarray] = None
        self.docnos: List[str] = []
        self.avg_dl: float = 0.0
        self.tokenizer = WordTokenizer()

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, corpus_iter: Iterable[dict],
              tokenizer: Optional[WordTokenizer] = None) -> "InvertedIndex":
        idx = cls()
        if tokenizer is not None:
            idx.tokenizer = tokenizer
        tmp: Dict[str, Dict[int, int]] = {}
        doc_lens: List[int] = []
        for i, doc in enumerate(corpus_iter):
            toks = idx.tokenizer.tokenize(doc["text"])
            idx.docnos.append(str(doc["docno"]))
            doc_lens.append(len(toks))
            counts: Dict[str, int] = {}
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
            for t, c in counts.items():
                tmp.setdefault(t, {})[i] = c
        idx.doc_len = np.asarray(doc_lens, dtype=np.float32)
        idx.avg_dl = float(idx.doc_len.mean()) if len(doc_lens) else 0.0
        for t, post in tmp.items():
            ids = np.fromiter(post.keys(), dtype=np.int32, count=len(post))
            tfs = np.fromiter(post.values(), dtype=np.float32, count=len(post))
            order = np.argsort(ids)
            idx.postings[t] = (ids[order], tfs[order])
        return idx

    @property
    def n_docs(self) -> int:
        return len(self.docnos)

    def idf(self, term: str) -> float:
        post = self.postings.get(term)
        df = len(post[0]) if post is not None else 0
        n = max(self.n_docs, 1)
        return float(np.log(1.0 + (n - df + 0.5) / (df + 0.5)))

    # -- persistence (Artifact-compatible directory layout) ----------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "postings.pkl"), "wb") as f:
            pickle.dump(self.postings, f, protocol=pickle.HIGHEST_PROTOCOL)
        np.save(os.path.join(path, "doc_len.npy"), self.doc_len)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"docnos": self.docnos, "avg_dl": self.avg_dl}, f)

    @classmethod
    def load(cls, path: str) -> "InvertedIndex":
        idx = cls()
        with open(os.path.join(path, "postings.pkl"), "rb") as f:
            idx.postings = pickle.load(f)
        idx.doc_len = np.load(os.path.join(path, "doc_len.npy"))
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        idx.docnos = meta["docnos"]
        idx.avg_dl = meta["avg_dl"]
        return idx

    # -- pipeline stage factories ------------------------------------------
    def bm25(self, *, k1: float = 1.2, b: float = 0.75,
             num_results: int = 1000) -> "BM25Retriever":
        return BM25Retriever(self, k1=k1, b=b, num_results=num_results)

    def indexer(self) -> "_IndexBuilder":
        return _IndexBuilder(self)


class _IndexBuilder(Indexer):
    """Terminal D→∅ stage that (re)builds an InvertedIndex in place."""

    def __init__(self, target: InvertedIndex):
        self.target = target

    def index(self, corpus_iter: Iterable[dict]) -> InvertedIndex:
        built = InvertedIndex.build(corpus_iter, self.target.tokenizer)
        self.target.__dict__.update(built.__dict__)
        return self.target

    def signature(self):
        return ("_IndexBuilder", id(self.target))


class BM25Retriever(Transformer):
    """Q → R: classic BM25 with TAAT accumulation."""

    input_columns = frozenset({"qid", "query"})
    output_columns = frozenset({"qid", "query", "docno", "score", "rank"})
    key_columns = ("qid", "query")
    one_to_many = True

    def __init__(self, index: InvertedIndex, *, k1: float = 1.2,
                 b: float = 0.75, num_results: int = 1000,
                 name: str = "bm25"):
        self.index = index
        self.k1 = float(k1)
        self.b = float(b)
        self.num_results = int(num_results)
        self.name = name

    def signature(self):
        return ("BM25Retriever", self.name, self.k1, self.b,
                self.num_results, self.index.n_docs)

    def with_cutoff(self, k: int) -> "BM25Retriever":
        """Absorb a downstream ``RankCutoff(k)`` into the retrieval
        depth (the optimizer's pushdown pass, ``core/rewrite.py``).
        Sound because truncation is prefix-closed: the top-k of the
        top-``num_results`` equals the global top-k for ``k <=
        num_results`` — ``score_query`` resolves boundary score ties
        deterministically by doc index, the same order ``lexsort``
        imposes inside the returned ranking."""
        if int(k) >= self.num_results:
            return self                  # already at most k results
        return BM25Retriever(self.index, k1=self.k1, b=self.b,
                             num_results=int(k), name=self.name)

    def score_query(self, query: str) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (doc_indices, scores) of the top-num_results docs."""
        idx = self.index
        acc = np.zeros(idx.n_docs, dtype=np.float32)
        dl_norm = self.k1 * (1.0 - self.b + self.b * idx.doc_len
                             / max(idx.avg_dl, 1e-9))
        for term in idx.tokenizer.tokenize(query):
            post = idx.postings.get(term)
            if post is None:
                continue
            ids, tfs = post
            w = idx.idf(term) * tfs * (self.k1 + 1.0) / (tfs + dl_norm[ids])
            acc[ids] += w
        nz = np.nonzero(acc)[0]
        if len(nz) > self.num_results:
            k = self.num_results
            part = np.argpartition(-acc[nz], k - 1)
            kth = acc[nz[part[k - 1]]]
            # deterministic boundary: keep everything strictly above the
            # k-th score, then the smallest doc indices among its ties —
            # matching the lexsort tie order below, so top-k is a prefix
            # of top-n for any n >= k (required by `% k` pushdown)
            above = nz[acc[nz] > kth]
            ties = np.sort(nz[acc[nz] == kth])
            nz = np.concatenate([above, ties[:k - len(above)]])
        order = np.lexsort((nz, -acc[nz]))
        nz = nz[order]
        return nz, acc[nz]

    def transform(self, inp: ColFrame) -> ColFrame:
        qids, docnos, scores, ranks, queries = [], [], [], [], []
        for qid, query in zip(inp["qid"].tolist(), inp["query"].tolist()):
            ids, sc = self.score_query(query)
            qids.extend([qid] * len(ids))
            queries.extend([query] * len(ids))
            docnos.extend(self.index.docnos[i] for i in ids)
            scores.extend(sc.tolist())
            ranks.extend(range(len(ids)))
        return ColFrame({"qid": qids, "query": queries, "docno": docnos,
                         "score": np.asarray(scores, dtype=np.float64),
                         "rank": np.asarray(ranks, dtype=np.int64)})


class TextLoader(Transformer):
    """R → R: attach the document text column (paper's text_loader())."""

    input_columns = frozenset({"qid", "docno"})
    key_columns = ("docno",)
    value_columns = ("text",)
    #: per-row column append: rows, order and existing columns untouched
    augment_only = True
    rank_preserving = True

    def __init__(self, text_map: Dict[str, str], name: str = "text_loader"):
        self.text_map = text_map
        self.name = name

    def transform(self, inp: ColFrame) -> ColFrame:
        texts = np.empty(len(inp), dtype=object)
        texts[:] = [self.text_map.get(str(d), "") for d in
                    inp["docno"].tolist()]
        return inp.assign(text=texts)

    def signature(self):
        return ("TextLoader", self.name, len(self.text_map))


class QueryExpander(Transformer):
    """Q → Q: deterministic pseudo query rewriter (doubles salient terms).

    Stands in for Doc2Query/RM3-style rewriters in tests of
    KeyValueCache (Q→Q caching family)."""

    input_columns = frozenset({"qid", "query"})
    key_columns = ("qid", "query")
    value_columns = ("query",)

    def __init__(self, repeat: int = 2):
        self.repeat = int(repeat)

    def transform(self, inp: ColFrame) -> ColFrame:
        new_q = np.empty(len(inp), dtype=object)
        for i, q in enumerate(inp["query"].tolist()):
            toks = q.split()
            new_q[i] = " ".join(toks + toks[:1] * (self.repeat - 1))
        return inp.assign(query=new_q)

    def signature(self):
        return ("QueryExpander", self.repeat)
