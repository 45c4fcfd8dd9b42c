"""Bucketed miss execution (counterpart of ``repro.caching.bucketing``).

PyTorch runs eagerly, so the buckets here bound the distinct batch
shapes a scorer sees; the reference's reasons follow.

The paper's caches run cache-miss rows through the wrapped component as
an arbitrary-size residual batch.  Under XLA every new batch size is a
fresh compilation; an experiment whose hit pattern produces 37-, then
61-, then 14-row miss batches would thrash the compile cache.  We pad
miss batches up to power-of-two buckets (with a floor), so the number of
distinct compiled shapes is O(log max_batch) — the standard serving
trick (cf. bucketed batching in fairseq/T5), applied here to *cache-miss
re-execution*, which is new relative to the paper.

The port also buckets the sequence: ``seq_bucket`` rounds a call's
longest row up to a multiple of ``SEQ_STEP`` columns, so an encoder
computes the columns its pairs fill and not the tokenizer's ``max_len``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np

from ..core import trace

__all__ = ["bucket_size", "seq_bucket", "SEQ_STEP", "pad_batch",
           "BucketedRunner"]

#: the columns a sequence bucket is a multiple of: at 16 a scorer
#: captures twice the graphs for under a tenth more of the saving
SEQ_STEP = 32


def bucket_size(n: int, *, floor: int = 8, ceiling: int = 1 << 20) -> int:
    """Smallest power-of-two ≥ n (≥ floor)."""
    if n <= 0:
        return floor
    return min(max(floor, 1 << (int(n - 1).bit_length())), ceiling)


def seq_bucket(longest: int, max_len: int) -> int:
    """Smallest multiple of ``SEQ_STEP`` ≥ longest (≥ SEQ_STEP), at most
    max_len."""
    return min(max_len, max(SEQ_STEP, -(-int(longest) // SEQ_STEP) * SEQ_STEP))


def pad_batch(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading dim of `arr` to `target` rows (repeat row 0 so
    padded rows stay in-distribution and produce finite scores)."""
    n = arr.shape[0]
    if n == target:
        return arr
    if n == 0:
        raise ValueError("cannot pad an empty batch")
    pad = np.broadcast_to(arr[:1], (target - n,) + arr.shape[1:])
    return np.concatenate([arr, pad], axis=0)


class BucketedRunner:
    """Runs ``fn(batch_arrays) -> scores`` over padded buckets.

    ``fn`` sees only O(log n) distinct leading dimensions, so a jitted
    scorer compiles a handful of times per experiment instead of once
    per miss batch.  Tracks the shapes issued for test assertions.

    While the span recorder is on (``core/trace.py``) it counts the
    first array's non-zero entries (an encoder's non-padding tokens)
    as ``encoder.tokens_useful`` and the padded bucket's entries as
    ``encoder.tokens_computed``.
    """

    def __init__(self, fn: Callable[..., np.ndarray], *, floor: int = 8,
                 max_bucket: int = 4096):
        self.fn = fn
        self.floor = int(floor)
        self.max_bucket = int(max_bucket)
        self.shapes_issued: Dict[int, int] = {}

    def __call__(self, *arrays: np.ndarray) -> np.ndarray:
        n = arrays[0].shape[0]
        if n == 0:
            return np.zeros((0,), dtype=np.float32)
        outs = []
        for lo in range(0, n, self.max_bucket):
            chunk = [a[lo:lo + self.max_bucket] for a in arrays]
            m = chunk[0].shape[0]
            b = bucket_size(m, floor=self.floor, ceiling=self.max_bucket)
            padded = [pad_batch(a, b) for a in chunk]
            self.shapes_issued[b] = self.shapes_issued.get(b, 0) + 1
            rec = trace.active()
            if rec is not None:
                rec.count("encoder.tokens_useful",
                          int(np.count_nonzero(chunk[0])))
                rec.count("encoder.tokens_computed", padded[0].size)
            out = np.asarray(self.fn(*padded))
            outs.append(out[:m])
        return np.concatenate(outs, axis=0)
