"""Tokenization for the IR substrate.

Counterpart of ``repro.ir.tokenizer``, copied: it is numpy only.

Two tokenizers:

* ``WordTokenizer`` — whitespace/punctuation split + lowercase + optional
  stopword removal; produces string terms for the inverted index.
* ``HashTokenizer`` — maps terms to integer ids in a fixed vocabulary via
  a stable FNV-1a hash (no vocab file needed).  Used by the neural
  scorers: deterministic, dependency-free, and identical across hosts —
  a requirement for the caching layer's determinism assumptions.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Sequence

import numpy as np

__all__ = ["WordTokenizer", "HashTokenizer", "fnv1a32"]

_TOKEN_RE = re.compile(r"[a-z0-9]+")

_STOPWORDS = frozenset("""
a an and are as at be by for from has he in is it its of on that the to was
were will with
""".split())


def fnv1a32(data: bytes) -> int:
    """32-bit FNV-1a (stable across runs/hosts, unlike hash())."""
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


class WordTokenizer:
    def __init__(self, remove_stopwords: bool = True):
        self.remove_stopwords = remove_stopwords

    def tokenize(self, text: str) -> List[str]:
        toks = _TOKEN_RE.findall(text.lower())
        if self.remove_stopwords:
            toks = [t for t in toks if t not in _STOPWORDS]
        return toks


class HashTokenizer:
    """term -> stable id in [n_special, vocab); 0 = PAD, 1 = CLS, 2 = SEP."""

    PAD, CLS, SEP = 0, 1, 2
    N_SPECIAL = 3

    def __init__(self, vocab_size: int, remove_stopwords: bool = False):
        if vocab_size <= self.N_SPECIAL:
            raise ValueError("vocab too small")
        self.vocab_size = int(vocab_size)
        self._word = WordTokenizer(remove_stopwords)

    def term_id(self, term: str) -> int:
        return self.N_SPECIAL + fnv1a32(term.encode()) % (
            self.vocab_size - self.N_SPECIAL)

    def encode(self, text: str, max_len: int) -> np.ndarray:
        ids = [self.term_id(t) for t in self._word.tokenize(text)][:max_len]
        out = np.zeros(max_len, dtype=np.int32)
        out[:len(ids)] = ids
        return out

    def encode_pair(self, a: str, b: str, max_len: int) -> np.ndarray:
        """[CLS] a [SEP] b — the cross-encoder input layout."""
        ta = [self.term_id(t) for t in self._word.tokenize(a)]
        tb = [self.term_id(t) for t in self._word.tokenize(b)]
        ids = [self.CLS] + ta[:max_len // 4] + [self.SEP] + tb
        ids = ids[:max_len]
        out = np.zeros(max_len, dtype=np.int32)
        out[:len(ids)] = ids
        return out

    def encode_batch(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        return np.stack([self.encode(t, max_len) for t in texts]) \
            if len(texts) else np.zeros((0, max_len), dtype=np.int32)
