"""Plain PyTorch version of ``flash_attention``: the semantics.

Softmax attention with grouped KV heads in fp32, cast to q's dtype at
the end.  Query head h reads KV head h // (H/K) through a
[B, K, G, Sq, hd] view of q, so the KV heads are never repeated.  The
causal mask aligns the last query with the last key
(j <= i + Sk - Sq); masked scores are -inf, so a row with no valid key
is NaN here, as in the reference's oracle (the kernels differ there).
"""
from __future__ import annotations

import math
import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q [B,H,Sq,hd]; k/v [B,K,Sk,hd]; H % K == 0 -> [B,H,Sq,hd] in q's
    dtype, scores scaled by 1/sqrt(hd)."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qg = q.float().reshape(B, K, G, Sq, hd)
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) \
        * (1.0 / math.sqrt(hd))
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq))
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)
