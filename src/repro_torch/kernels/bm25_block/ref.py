"""Plain PyTorch version of ``bm25_block``: the semantics.

    score(d) = sum_t idf[t] * tf*(k1+1) / (tf + k1*(1-b+b*dl/avg_dl))

in fp32, where an entry with tf == 0 adds exactly 0.
"""
from __future__ import annotations

import torch

__all__ = ["bm25_block_ref"]


def bm25_block_ref(tf: torch.Tensor, idf: torch.Tensor,
                   doc_len: torch.Tensor, *, k1: float = 1.2,
                   b: float = 0.75, avg_dl: float = 1.0) -> torch.Tensor:
    """tf [T, D] term-frequency tile; idf [T]; doc_len [D] -> scores [D]
    float32."""
    tf, idf, doc_len = tf.float(), idf.float(), doc_len.float()
    dl_norm = k1 * (1.0 - b + b * doc_len / avg_dl)               # [D]
    sat = tf * (k1 + 1.0) / (tf + dl_norm[None, :])
    sat = torch.where(tf > 0, sat, torch.zeros((), device=tf.device))
    return idf @ sat
