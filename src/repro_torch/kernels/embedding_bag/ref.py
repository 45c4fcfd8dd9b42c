"""Plain PyTorch version of ``embedding_bag``: the semantics.

Gather the clipped rows, weight them, sum over the bag in fp32 and cast
to the table's dtype, as the kernel does: the weights are cast to the
table's dtype first (the reference kernel's order), and ids are clipped
to [0, V-1] as the reference's oracle clips.  The ``mean`` combiner
divides after that cast, as the reference's ops do.

``embedding_bag_kernel_order`` repeats the CUDA kernel's arithmetic step
by step, for the tests: the order of its sums and where it rounds.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["embedding_bag_ref", "embedding_bag_kernel_order"]


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


def embedding_bag_kernel_order(table: torch.Tensor, ids: torch.Tensor,
                               weights: Optional[torch.Tensor] = None,
                               combiner: str = "sum") -> torch.Tensor:
    """The kernel's rounding order: per bag and column an fp32 ``fmaf``
    chain in l order (the exact product plus the sum, rounded once to
    fp32, up to a double rounding through float64), the weights rounded
    to the table's dtype T first; ``mean``'s epilogue divides T(sum) by
    max(T(the fp32 weight sum in l order, or L), T(1e-9)) in fp32 and
    rounds to T."""
    T, (B, L) = table.dtype, ids.shape
    rows = table[ids.long().clamp(0, table.shape[0] - 1)].double()
    w = (weights.to(T) if weights is not None
         else torch.ones(B, L, dtype=T, device=table.device)).double()
    acc = torch.zeros(B, table.shape[1], dtype=torch.float32,
                      device=table.device)
    w_sum = torch.zeros(B, dtype=torch.float32, device=table.device)
    for l in range(L):
        acc = (rows[:, l] * w[:, l, None] + acc.double()).float()
        w_sum = w_sum + w[:, l].float()
    out = acc.to(T)
    if combiner == "sum":
        return out
    if combiner != "mean":
        raise ValueError(f"combiner is 'sum' or 'mean', not {combiner!r}")
    lo = torch.tensor(1e-9).to(T).float()
    den = w_sum.to(T).float()
    den = torch.where(den < lo, lo, den)
    return (out.float() / den[:, None]).to(T)
