"""``flash_attention_op``: the reference's offsets, empty inputs and
dispatch by device.

The tensor's device decides: CUDA tensors go to the hand-written
kernel (which raises on anything it cannot take), CPU tensors to the
plain version.  Nothing falls back from one to the other.  As in the
reference kernel, keys at or past ``sk_valid`` (default Sk) are masked
and the causal offset is ``q_offset`` (default ``sk_valid - Sq``).  The
reference's op pads Sq and Sk to its block sizes (a decode step's one
query to 8 rows), passes the unpadded Sk as ``sk_valid`` and cuts the
padded rows off again; the kernel masks its ragged edges itself and
needs no padding, which changes no row that has a valid key.  A decode
step against a preallocated cache passes ``sk_valid`` = its filled
length, so no slice of the cache is copied.

The op has no backward: the reference kernel has none (no ``custom_vjp``
in the JAX package) and the CUDA kernel writes into a tensor autograd
does not track.  So under grad mode, with any of q, k, v requiring a
gradient, it raises on both devices rather than drop the gradient on the
card; a caller that differentiates attention takes the plain path
(``models.lm``'s ``attention="plain"``, or ``attention_ref``).
"""
from __future__ import annotations

import torch

from .kernel import flash_attention
from .ref import attention_ref

__all__ = ["flash_attention_op"]


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, sk_valid: int | None = None,
                       q_offset: int | None = None) -> torch.Tensor:
    """q [B,H,Sq,hd]; k/v [B,K,Sk,hd]; H % K == 0 -> [B,H,Sq,hd] in q's
    dtype."""
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_op has no backward (nor has the reference "
            "kernel): under autograd use the plain attention, "
            "models.lm's attention='plain' or "
            "kernels.flash_attention.ref.attention_ref")
    if q.numel() == 0:
        return torch.zeros_like(q)
    if q.device.type == "cuda":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               sk_valid=sk_valid, q_offset=q_offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sk_valid=sk_valid,
                             q_offset=q_offset)
    raise ValueError(f"flash_attention_op runs on cuda or cpu, not "
                     f"{q.device}")
