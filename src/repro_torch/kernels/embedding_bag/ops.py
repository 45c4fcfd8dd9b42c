"""``embedding_bag_op``: the combiner, empty inputs and dispatch by
device.

The tensor's device decides: CUDA tensors go to the hand-written
kernel (which raises on anything it cannot take), CPU tensors to the
plain version.  Nothing falls back from one to the other.  The kernel
sums each bag.  The ``mean`` combiner divides that sum, after its cast
to the table's dtype, by the bag's weight sum (or L) cast to the same
dtype and held at 1e-9 or more, as the reference's ops do:

* weights None or in the table's dtype: the kernel's epilogue divides,
  with the weight sum taken in fp32 in l order; one launch;
* weights in another dtype (say f32 weights on a bf16 table): the kernel
  sums with the weights cast to the table's dtype, and the division
  follows here, by the sum of the weights as given.

The reference pads d to a multiple of 128 for the TPU's lanes; that does
not change the result, and the kernel needs no padding.

The op has no backward, as the reference kernel has none: under grad
mode, with the table or the weights requiring a gradient, it raises on
both devices (the CUDA kernel's output is not tracked by autograd); a
caller that differentiates a bag takes ``embedding_bag_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import embedding_bag
from .ref import embedding_bag_ref

__all__ = ["embedding_bag_op"]


def embedding_bag_op(table: torch.Tensor, ids: torch.Tensor,
                     weights: Optional[torch.Tensor] = None, *,
                     combiner: str = "sum") -> torch.Tensor:
    """table [V, d]; ids [B, L] int32; weights [B, L] or None -> [B, d]
    in the table's dtype, the ``sum`` or ``mean`` of each bag."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner is 'sum' or 'mean', not {combiner!r}")
    if ids.device != table.device or (weights is not None
                                      and weights.device != table.device):
        raise ValueError("table, ids and weights must be on one device")
    if torch.is_grad_enabled() and (table.requires_grad or (
            weights is not None and weights.requires_grad)):
        raise RuntimeError(
            "embedding_bag_op has no backward (nor has the reference "
            "kernel): under autograd use the plain version, "
            "kernels.embedding_bag.ref.embedding_bag_ref")
    n_bags, d = ids.shape[0], table.shape[1]
    if n_bags == 0 or d == 0:
        return torch.zeros((n_bags, d), dtype=table.dtype,
                           device=table.device)
    if table.device.type == "cuda":
        fused = combiner == "mean" and (weights is None
                                        or weights.dtype == table.dtype)
        out = embedding_bag(table.contiguous(), ids.contiguous(), weights,
                            mean=fused)
        if combiner == "sum" or fused:
            return out
        denom = weights.sum(dim=1, keepdim=True)
        return out / torch.clamp(denom.to(out.dtype), min=1e-9)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, weights, combiner)
    raise ValueError(f"embedding_bag_op runs on cuda or cpu, not "
                     f"{table.device}")
