"""Operations and bytes of the cross-encoder's forward pass, from shapes.

They count what the inputs need, not what the program computes: each
pair at its own unpadded length ``n``, attention at ``n**2``.  A padded
token, or a padded row of a bucket, adds nothing here, so padding that
the program computes shows as a low ``mfu`` and roofline share.

Operations are the matrix products (two per multiply-add):

* per layer and pair: ``2 n D (3 H hd)`` for Q, K and V, ``2 n**2 H hd``
  for the scores, ``2 n**2 H hd`` for the weighted values, ``2 n H hd D``
  for the output projection, ``4 n D F`` for the feed-forward pair;
* per pair: ``2 D`` for the score head.

Softmax, norms and GELU are elementwise and not counted.

Bytes, in the configuration's dtype: every weight matrix is read once per
forward call (a call is one batch); each pair reads its ``n`` rows of the
token and position embeddings and its ids; every activation is written
once and read once: per layer ``h, q, k, v, attn, x, h2, x`` (``n D``
each, ``n H hd`` for q, k, v, attn), scores and probabilities
(``H n**2`` each) and the feed-forward's two ``n F`` tensors.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

__all__ = ["pair_flops", "call_bytes", "weight_bytes"]


def _widths(cfg: Dict):
    D, H, F_ = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["intermediate_size"]
    return cfg["num_hidden_layers"], D, H, D // H, F_


def pair_flops(cfg: Dict, n: np.ndarray) -> np.ndarray:
    """FLOPs of one forward pass of each pair of unpadded length ``n``."""
    L, D, H, hd, F_ = _widths(cfg)
    n = np.asarray(n, dtype=np.float64)
    per_layer = (2 * n * D * 3 * H * hd + 4 * n * n * H * hd
                 + 2 * n * H * hd * D + 4 * n * D * F_)
    return L * per_layer + 2 * D


def weight_bytes(cfg: Dict, itemsize: int = 4) -> int:
    """Bytes of the weights every forward call reads whole (not the
    embedding tables, read row by row)."""
    L, D, H, hd, F_ = _widths(cfg)
    per_layer = 4 * D * H * hd + 2 * D * F_ + 2 * D
    return itemsize * (L * per_layer + D + D)


def call_bytes(cfg: Dict, lengths: Iterable[int], itemsize: int = 4) -> float:
    """Least bytes of one forward call over pairs of these lengths."""
    L, D, H, hd, F_ = _widths(cfg)
    n = np.asarray(list(lengths), dtype=np.float64)
    if n.size == 0:
        return 0.0
    embed = n * (2 * D * itemsize + 4)             # token + position rows, ids
    acts = L * (4 * n * D + 4 * n * H * hd + 2 * H * n * n + 2 * n * F_)
    return float(weight_bytes(cfg, itemsize)
                 + embed.sum() + 2 * itemsize * acts.sum())
