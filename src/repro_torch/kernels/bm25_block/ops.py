"""``bm25_block_op``: dtypes, empty inputs and dispatch by device.

The tensor's device decides: CUDA tensors go to the hand-written
kernel (which raises on anything it cannot take), CPU tensors to the
plain version.  Nothing falls back from one to the other.  The
reference pads T to 8 and D to 128 for the TPU's tiles (padded terms
have tf = 0 and add 0; padded docs are cut off again), which does not
change the scores; the kernel masks its ragged edge and needs no
padding.
"""
from __future__ import annotations

import torch

from .kernel import bm25_block
from .ref import bm25_block_ref

__all__ = ["bm25_block_op"]


def bm25_block_op(tf: torch.Tensor, idf: torch.Tensor, doc_len: torch.Tensor,
                  *, k1: float = 1.2, b: float = 0.75,
                  avg_dl: float = 1.0) -> torch.Tensor:
    """tf [T, D]; idf [T]; doc_len [D] -> scores [D] float32, the
    BM25 weights of the T rows summed per doc."""
    if idf.device != tf.device or doc_len.device != tf.device:
        raise ValueError("tf, idf and doc_len must be on one device")
    if tf.shape[1] == 0:
        return torch.zeros(0, dtype=torch.float32, device=tf.device)
    tf, idf, doc_len = (x.to(torch.float32).contiguous()
                        for x in (tf, idf, doc_len))
    if tf.device.type == "cuda":
        return bm25_block(tf, idf, doc_len, k1=k1, b=b, avg_dl=avg_dl)
    if tf.device.type == "cpu":
        return bm25_block_ref(tf, idf, doc_len, k1=k1, b=b, avg_dl=avg_dl)
    raise ValueError(f"bm25_block_op runs on cuda or cpu, not {tf.device}")
