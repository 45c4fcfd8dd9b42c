"""The cross-encoder's input layout, from the published description of the
port's hash tokenizer:

* words are the runs of ``[a-z0-9]`` in the lower-cased text, with no
  stopword removal;
* a word's id is ``3 + fnv1a32(word) % (vocab - 3)``; 0 pads, 1 opens
  (``[CLS]``), 2 separates (``[SEP]``);
* a pair is ``[CLS]``, at most ``max_len // 4`` query words, ``[SEP]``,
  the passage's words, cut at ``max_len``.

``pair_ids`` returns the unpadded ids; the reference encodes each pair at
its own length.
"""
from __future__ import annotations

import re
from typing import List

__all__ = ["word_id", "pair_ids", "CLS", "SEP"]

CLS, SEP, N_SPECIAL = 1, 2, 3
_WORD = re.compile(r"[a-z0-9]+")


def _fnv1a32(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def word_id(word: str, vocab: int) -> int:
    return N_SPECIAL + _fnv1a32(word.encode()) % (vocab - N_SPECIAL)


def pair_ids(query: str, text: str, vocab: int, max_len: int,
             memo: dict) -> List[int]:
    """Ids of ``[CLS] query [SEP] text``; ``memo`` maps word -> id."""
    def ids(s: str) -> List[int]:
        out = []
        for w in _WORD.findall(s.lower()):
            i = memo.get(w)
            if i is None:
                i = memo[w] = word_id(w, vocab)
            out.append(i)
        return out
    return ([CLS] + ids(query)[:max_len // 4] + [SEP] + ids(text))[:max_len]
