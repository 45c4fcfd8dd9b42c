"""``dense_topk_op``: k clamping, empty inputs and dispatch by device.

The tensor's device decides: CUDA tensors go to the hand-written
kernel (which raises on anything it cannot take), CPU tensors to the
plain version.  Nothing falls back from one to the other.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .kernel import dense_topk
from .ref import dense_topk_ref

__all__ = ["dense_topk_op"]


def dense_topk_op(q: torch.Tensor, c: torch.Tensor, *, k: int = 100
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [Q, d]; c [N, d] -> (vals [Q, k] f32, idxs [Q, k] i32), k
    clamped to N."""
    if q.device != c.device:
        raise ValueError(f"q and c must be on one device, got {q.device} "
                         f"and {c.device}")
    n_q, n_docs = q.shape[0], c.shape[0]
    k = int(min(max(1, k), n_docs)) if n_docs else 0
    if n_q == 0 or n_docs == 0:
        return (torch.zeros((n_q, k), dtype=torch.float32, device=q.device),
                torch.zeros((n_q, k), dtype=torch.int32, device=q.device))
    if q.device.type == "cuda":
        return dense_topk(q, c, k=k)
    if q.device.type == "cpu":
        return dense_topk_ref(q, c, k=k)
    raise ValueError(f"dense_topk_op runs on cuda or cpu, not {q.device}")
