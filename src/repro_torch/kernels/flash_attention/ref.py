"""Plain PyTorch versions of ``flash_attention``: the semantics, and the
arithmetic of the kernel's paths.

``attention_ref`` is the semantics: softmax attention with grouped KV
heads in fp32, cast to q's dtype at the end.  Query head h reads KV
head h // (H/K) through a [B, K, G, Sq, hd] view of q, so the KV heads
are never repeated.  As in the reference's kernel, keys at or past
``sk_valid`` (default Sk) are masked, and the causal mask keeps key j
for query row i when j <= i + ``q_offset`` (default sk_valid - Sq: the
last query sees the last valid key); masked scores are -inf, so a row
with no valid key is NaN here, as in the reference's oracle (the kernels
differ there: they write 0).

``attention_bf16p_ref`` repeats what the ``"wgmma"`` path computes
(unnormalised probabilities rounded to bf16 for the PV product), and
``bf16p_excess`` is the bound that path is held to.
``attention_split_ref`` and ``merge_partials`` repeat the ``"decode"``
path's split of the key axis and its merge of partial (m, l, acc).
"""
from __future__ import annotations

import math
import torch

__all__ = ["attention_ref", "attention_bf16p_ref", "bf16p_excess",
           "attention_split_ref", "merge_partials", "offsets", "NEG_INF"]

NEG_INF = -1e30     # the reference's mask value, and an empty split's m


def offsets(Sq: int, Sk: int, sk_valid: int | None,
            q_offset: int | None) -> tuple[int, int]:
    """(sk_valid, q_offset) with the reference kernel's defaults: every
    key valid, and the last query row aligned with the last valid key."""
    sk_valid = Sk if sk_valid is None else int(sk_valid)
    if not 0 <= sk_valid <= Sk:
        raise ValueError(f"sk_valid must lie in [0, Sk = {Sk}], got "
                         f"{sk_valid}")
    return sk_valid, sk_valid - Sq if q_offset is None else int(q_offset)


def _valid(Sq: int, k0: int, k1: int, causal: bool, sk_valid: int,
           q_offset: int, device):
    """[Sq, k1 - k0] mask of the keys k0..k1-1 each query row may see."""
    j = torch.arange(k0, k1, device=device)[None, :]
    keep = (j < sk_valid).expand(Sq, k1 - k0)
    if causal:
        keep = keep & (j <= torch.arange(Sq, device=device)[:, None]
                       + q_offset)
    return keep


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sk_valid: int | None = None,
                  q_offset: int | None = None) -> torch.Tensor:
    """q [B,H,Sq,hd]; k/v [B,K,Sk,hd]; H % K == 0 -> [B,H,Sq,hd] in q's
    dtype, scores scaled by 1/sqrt(hd)."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    sk_valid, q_offset = offsets(Sq, Sk, sk_valid, q_offset)
    qg = q.float().reshape(B, K, G, Sq, hd)
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) \
        * (1.0 / math.sqrt(hd))
    if causal or sk_valid < Sk:
        scores = scores.masked_fill(
            ~_valid(Sq, 0, Sk, causal, sk_valid, q_offset, q.device),
            float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def attention_bf16p_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, block_k: int = 128,
                        sk_valid: int | None = None,
                        q_offset: int | None = None) -> torch.Tensor:
    """The ``"wgmma"`` path's arithmetic, plainly: fp32 scores, an online
    softmax over tiles of ``block_k`` keys, the unnormalised
    probabilities rounded to bf16 for the PV product (the tensor cores
    take P in bf16) while l sums them in fp32, the output divided once
    and cast to q's dtype once.  A row with no valid key gives 0, as the
    kernels do."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    sk_valid, q_offset = offsets(Sq, Sk, sk_valid, q_offset)
    qg = q.float().reshape(B, K, G, Sq, hd)
    kf, vf = k.float(), v.float()
    m = torch.full((B, K, G, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for k0 in range(0, sk_valid, block_k):
        k1 = min(sk_valid, k0 + block_k)
        s = torch.einsum("bkgqh,bksh->bkgqs", qg, kf[:, :, k0:k1]) \
            * (1.0 / math.sqrt(hd))
        s = s.masked_fill(~_valid(Sq, k0, k1, causal, sk_valid, q_offset,
                                  q.device), float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bkgqs,bksh->bkgqh", p.to(torch.bfloat16).float(),
            vf[:, :, k0:k1])
        m = m_new
    out = torch.where(l > 0, acc / l.clamp_min(1e-30), torch.zeros_like(acc))
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def bf16p_excess(got: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, causal: bool = True,
                 plain: torch.Tensor | None = None,
                 sk_valid: int | None = None,
                 q_offset: int | None = None) -> torch.Tensor:
    """|got - plain| / (2**-7 |plain| + 2**-8 A + 1e-4) elementwise, in
    fp32: the share of its bound that each element of a ``"wgmma"``
    output uses (> 1 is beyond it).  ``plain`` is ``attention_ref(q, k,
    v)``; A = Σⱼ pⱼ|vⱼ| is ``attention_ref`` of |v| in fp32.

    One rounding of the output is 2**-7 |plain|.  Rounding the
    unnormalised probabilities to bf16 moves each by at most 2**-9 of
    itself, so the output by at most 2**-9 A; the bound allows twice
    bf16's unit roundoff, 2**-8 A.  The reference's own oracle rounds
    the probabilities to bf16 and needs this bound too; the fp32-P
    paths stay held at one rounding of the output."""
    kw = dict(causal=causal, sk_valid=sk_valid, q_offset=q_offset)
    if plain is None:
        plain = attention_ref(q, k, v, **kw)
    a = attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    plain = plain.float()
    return (got.float() - plain).abs() \
        / (2 ** -7 * plain.abs() + 2 ** -8 * a + 1e-4)


def merge_partials(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """Merges S partial softmax states of a row: m, l [..., S] (max score
    and sum of exp(s - m) over a split's keys; NEG_INF and 0 for a split
    with no valid key), acc [..., S, hd] (Σ exp(s - m) v).  Returns
    Σ acc·exp(m - M) / Σ l·exp(m - M), M the largest m, and 0 where no
    split has a valid key — what the ``"decode"`` path's combine does."""
    top = m.amax(-1, keepdim=True)
    w = torch.exp(m - top)
    den = (w * l).sum(-1)
    num = (w[..., None] * acc).sum(-2)
    return torch.where(den[..., None] > 0,
                       num / den.clamp_min(1e-30)[..., None],
                       torch.zeros_like(num))


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, keys_per_split: int,
                        sk_valid: int | None = None,
                        q_offset: int | None = None) -> torch.Tensor:
    """The ``"decode"`` path's arithmetic, plainly: the key axis cut into
    splits of ``keys_per_split`` keys, each split's (m, l, acc) in fp32
    with its probabilities in fp32, then ``merge_partials``.  A row with
    no valid key gives 0."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    sk_valid, q_offset = offsets(Sq, Sk, sk_valid, q_offset)
    qg = q.float().reshape(B, K, G, Sq, hd)
    ms, ls, accs = [], [], []
    for k0 in range(0, max(sk_valid, 1), keys_per_split):
        k1 = min(sk_valid, k0 + keys_per_split)
        s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()[:, :, k0:k1]) \
            * (1.0 / math.sqrt(hd))
        valid = _valid(Sq, k0, k1, causal, sk_valid, q_offset, q.device)
        s = s.masked_fill(~valid, NEG_INF)
        m = s.amax(-1) if k1 > k0 else \
            torch.full(qg.shape[:-1], NEG_INF, device=q.device)
        p = torch.exp(s - m[..., None]) * valid
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgqs,bksh->bkgqh", p,
                                 v.float()[:, :, k0:k1]))
    out = merge_partials(torch.stack(ms, -1), torch.stack(ls, -1),
                         torch.stack(accs, -2))
    return out.reshape(B, H, Sq, hd).to(q.dtype)
