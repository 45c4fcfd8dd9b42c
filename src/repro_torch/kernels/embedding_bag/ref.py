"""Plain PyTorch version of ``embedding_bag``: the semantics.

Gather the clipped rows, weight them, sum over the bag in fp32 and cast
to the table's dtype, as the kernel does: the weights are cast to the
table's dtype first (the reference kernel's order), and ids are clipped
to [0, V-1] as the reference's oracle clips.  The ``mean`` combiner
divides after that cast, as the reference's ops do.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["embedding_bag_ref"]


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      combiner: str = "sum") -> torch.Tensor:
    """table [V, d]; ids [B, L] int32; weights [B, L] (None = all ones)
    -> [B, d] in the table's dtype: per bag the weighted sum, or for
    ``mean`` that sum over the bag's weight sum (or L), held at 1e-9 or
    more."""
    emb = table[ids.long().clamp(0, table.shape[0] - 1)].float()  # [B,L,d]
    if weights is not None:
        emb = emb * weights.to(table.dtype).float()[..., None]
    out = emb.sum(dim=1).to(table.dtype)
    if combiner == "sum":
        return out
    if combiner != "mean":
        raise ValueError(f"combiner is 'sum' or 'mean', not {combiner!r}")
    n = weights.sum(dim=1, keepdim=True) if weights is not None \
        else torch.tensor(float(ids.shape[1]), device=out.device)
    return out / n.to(out.dtype).clamp(min=1e-9)
