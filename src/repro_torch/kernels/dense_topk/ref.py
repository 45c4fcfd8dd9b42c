"""Plain PyTorch version of ``dense_topk``: the semantics.

An fp32 matmul, then a stable descending sort.  Stability keeps equal
scores in ascending doc index, the kernel's tie order.  ``torch.topk``
promises no order among ties, so it is not used.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["dense_topk_ref"]


def dense_topk_ref(q: torch.Tensor, c: torch.Tensor, *, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [Q, d]; c [N, d] -> (vals [Q, k] f32, idxs [Q, k] i32)."""
    s = torch.matmul(q.float(), c.float().T)
    vals, idxs = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idxs[:, :k].to(torch.int32)
