"""Decoder-only transformer LM family (dense + MoE) in PyTorch.

Counterpart of ``repro.models.lm``: GQA with optional qk-norm and QKV
bias, RoPE, a SwiGLU FFN or top-k routed MoE (both of the reference's
dispatches: the flat GShard-style sort, and the grouped gather-only form
of ``dispatch_groups > 0``), ``forward``, ``causal_lm_loss``,
``prefill`` and ``decode_one``.  Parameters are nested dicts of tensors
in the reference's layout (``load_params`` bridges the reference's
numpy tree or draws from a ``torch.Generator``).

Attention.  Wherever the reference's attention computes the causal
softmax over every earlier key (``_plain_attention`` and
``_chunked_attention`` without a window, and the decode step's masked
softmax), the port calls ``flash_attention_op``: on the card the
hand-written kernel (``"wgmma"`` for a bf16 prefill, ``"decode"`` for a
decode step, ``"simt"`` for an f32 prefill), on the CPU its plain
version.  A decode step passes ``sk_valid = pos + 1``, so the kernel
reads the preallocated cache in place.  With ``attn_window`` set, or
with ``attention="plain"``, the port runs its own plain attention:
the reference's ``_plain_attention`` and ``_chunked_attention``, with
its -1e30 mask and its probabilities cast to the activation's dtype
before the PV product.  The window is the configuration's choice, not a
fallback: the kernel has no window.  A kernel that fails raises.

What does not carry over:

* ``scan_layers`` and ``remat`` change how XLA compiles the reference,
  not what a forward pass computes; the port loops over the layers and
  keeps no activations for a backward pass (``remat`` returns with
  training);
* ``gqa_repeat_kv`` only changes the reference's sharding (repeated KV
  heads compute the same scores); the port always reads grouped heads;
* ``shard_act`` is the identity (``models.common``), so no call of it
  is kept.

The KV cache is head-major, ``[L, B, K, S, hd]`` (the reference's is
``[L, B, S, K, hd]``): a layer's slice is the kernel's ``[B, K, S, hd]``
as it stands, so no step copies it.  ``decode_one`` writes the new
token's keys and values into the cache in place and returns the same
dict; its ``pos`` is a Python int where the reference traces a scalar.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.flash_attention import flash_attention_op
from .common import ParamSpec, count_params, load_weights, rms_norm, rope

__all__ = ["LMConfig", "param_specs", "load_params", "forward",
           "causal_lm_loss", "prefill", "decode_one", "init_cache_specs",
           "init_cache", "num_params", "active_params", "moe_capacity",
           "ATTENTION"]

#: the two ways to compute attention: the kernel (where the reference's
#: attention computes its function) or the port's plain version
ATTENTION = ("flash", "plain")
NEG = -1e30      # the reference's mask value


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    # MoE (0 experts = dense)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # arch flags
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_base: float = 10000.0
    tie_embeddings: bool = False
    # execution
    dtype: torch.dtype = torch.bfloat16
    vocab_pad_multiple: int = 256
    attn_window: Optional[int] = None        # sliding window (long-context)
    attn_chunk: int = 512                    # q-block for chunked attention
    chunked_attn_threshold: int = 2048       # use chunked attn when S >=
    remat: str = "full"                      # kept for parity; see above
    fuse_qkv: bool = False                   # fused [D, H+2K, hd] projection
    gqa_repeat_kv: bool = False              # kept for parity; see above
    dispatch_groups: int = 0                 # MoE dispatch groups
    scan_layers: bool = True                 # kept for parity; see above

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else \
            self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_specs(cfg: LMConfig) -> Dict:
    L, D, H, K = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, F_, Vp = cfg.head_dim, cfg.d_ff, cfg.padded_vocab
    dt = cfg.dtype
    lyr: Dict[str, ParamSpec] = {
        "ln1": ParamSpec((L, D), ("layers", "norm"), dt, init="ones"),
        "ln2": ParamSpec((L, D), ("layers", "norm"), dt, init="ones"),
    }
    if cfg.fuse_qkv:
        lyr["wqkv"] = ParamSpec((L, D, H + 2 * K, hd),
                                ("layers", "d_model", "heads", "head_dim"), dt)
    else:
        lyr["wq"] = ParamSpec((L, D, H, hd),
                              ("layers", "d_model", "heads", "head_dim"), dt)
        lyr["wk"] = ParamSpec((L, D, K, hd),
                              ("layers", "d_model", "kv_heads", "head_dim"), dt)
        lyr["wv"] = ParamSpec((L, D, K, hd),
                              ("layers", "d_model", "kv_heads", "head_dim"), dt)
    lyr["wo"] = ParamSpec((L, H, hd, D),
                          ("layers", "heads", "head_dim", "d_model_out"), dt)
    if cfg.qkv_bias:
        lyr["bq"] = ParamSpec((L, H, hd), ("layers", "heads", "head_dim"),
                              dt, init="zeros")
        lyr["bk"] = ParamSpec((L, K, hd), ("layers", "kv_heads", "head_dim"),
                              dt, init="zeros")
        lyr["bv"] = ParamSpec((L, K, hd), ("layers", "kv_heads", "head_dim"),
                              dt, init="zeros")
    if cfg.qk_norm:
        lyr["q_norm"] = ParamSpec((L, hd), ("layers", "norm"), dt, init="ones")
        lyr["k_norm"] = ParamSpec((L, hd), ("layers", "norm"), dt, init="ones")
    if cfg.is_moe:
        E = cfg.n_experts
        lyr["router"] = ParamSpec((L, D, E), ("layers", "d_model", "experts"),
                                  torch.float32)
        lyr["w1"] = ParamSpec((L, E, D, F_),
                              ("layers", "experts", "d_model", "d_ff"), dt)
        lyr["w3"] = ParamSpec((L, E, D, F_),
                              ("layers", "experts", "d_model", "d_ff"), dt)
        lyr["w2"] = ParamSpec((L, E, F_, D),
                              ("layers", "experts", "d_ff", "d_model_out"), dt)
    else:
        lyr["w1"] = ParamSpec((L, D, F_), ("layers", "d_model", "d_ff"), dt)
        lyr["w3"] = ParamSpec((L, D, F_), ("layers", "d_model", "d_ff"), dt)
        lyr["w2"] = ParamSpec((L, F_, D), ("layers", "d_ff", "d_model_out"),
                              dt)
    specs = {
        "embed": ParamSpec((Vp, D), ("vocab", "d_model"), dt, init="embed",
                           init_scale=0.02),
        "ln_f": ParamSpec((D,), ("norm",), dt, init="ones"),
        "layers": lyr,
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((D, Vp), ("d_model", "vocab"), dt)
    return specs


def num_params(cfg: LMConfig) -> int:
    return count_params(param_specs(cfg))


def active_params(cfg: LMConfig) -> int:
    """Params touched per token (dense = all; MoE = top_k of E experts)."""
    total = num_params(cfg)
    if not cfg.is_moe:
        return total
    L, E, D, F_ = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    return total - L * E * 3 * D * F_ + L * cfg.top_k * 3 * D * F_


def load_params(cfg: LMConfig, seed: int = 0, *,
                params: Optional[Dict] = None,
                device: Union[str, torch.device, None] = None
                ) -> Tuple[Dict, Tuple]:
    """(weights on the device, their source).  ``params`` is a nested
    dict of numpy arrays in the reference's layout (bridged with
    ``params_from_numpy``, dtypes kept, the router's fp32 included);
    without it the weights are drawn from
    ``torch.Generator().manual_seed(seed)`` (``common.load_weights``)."""
    return load_weights(param_specs(cfg), seed, params=params,
                        device=device)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(x, layer, cfg: LMConfig):
    """x: [B,S,D] -> q [B,S,H,hd], k/v [B,S,K,hd] (rope NOT yet applied)."""
    if cfg.fuse_qkv:
        qkv = torch.einsum("bsd,dnh->bsnh", x, layer["wqkv"])
        q = qkv[..., :cfg.n_heads, :]
        k = qkv[..., cfg.n_heads:cfg.n_heads + cfg.n_kv_heads, :]
        v = qkv[..., cfg.n_heads + cfg.n_kv_heads:, :]
    else:
        q = torch.einsum("bsd,dnh->bsnh", x, layer["wq"])
        k = torch.einsum("bsd,dnh->bsnh", x, layer["wk"])
        v = torch.einsum("bsd,dnh->bsnh", x, layer["wv"])
    if cfg.qkv_bias:
        q = q + layer["bq"]
        k = k + layer["bk"]
        v = v + layer["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, layer["q_norm"])
        k = rms_norm(k, layer["k_norm"])
    return q, k, v


def _keep(qpos: torch.Tensor, kpos: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """Causal (+ optional sliding window) mask [Sq, Sk]; True = keep."""
    keep = kpos[None, :] <= qpos[:, None]
    if window is not None:
        keep &= kpos[None, :] > qpos[:, None] - window
    return keep


def _plain_attention(q, kh, vh, cfg: LMConfig, q_offset: int = 0):
    """The reference's ``_plain_attention``: q [B,Sq,H,hd], kh/vh
    [B,K,Sk,hd] (head-major) -> [B,Sq,H,hd], query row i at position
    i + ``q_offset`` (a decode step's one row at ``pos``, against the
    whole cache: keys past ``pos`` are masked as the reference's
    ``layer_decode`` masks them)."""
    B, Sq, H, hd = q.shape
    K, Sk = kh.shape[1], kh.shape[2]
    G = H // K
    keep = _keep(torch.arange(Sq, device=q.device) + q_offset,
                 torch.arange(Sk, device=q.device), cfg.attn_window)
    qg = q.reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgh,bksh->bkgqs", qg, kh).float() \
        * (1.0 / math.sqrt(hd))
    scores = torch.where(keep, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bksh->bqkgh", probs, vh)
    return out.reshape(B, Sq, H, hd)


def _chunked_attention(q, kh, vh, cfg: LMConfig):
    """The reference's ``_chunked_attention``: q-chunks of ``attn_chunk``
    rows against every key, the unnormalised probabilities cast to the
    activation's dtype, then divided by their fp32 sum."""
    B, Sq, H, hd = q.shape
    K, Sk = kh.shape[1], kh.shape[2]
    G = H // K
    C = min(cfg.attn_chunk, Sq)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for c0 in range(0, Sq, C):
        qc = q[:, c0:c0 + C]
        n = qc.shape[1]
        if n < C:      # the reference pads the last chunk with zero rows
            qc = F.pad(qc, (0, 0, 0, 0, 0, C - n))
        scores = torch.einsum("bqkgh,bksh->bkgqs",
                              qc.reshape(B, C, K, G, hd), kh).float() \
            * (1.0 / math.sqrt(hd))
        keep = _keep(c0 + torch.arange(C, device=q.device), kpos,
                     cfg.attn_window)
        scores = torch.where(keep, scores, NEG)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        l = p.sum(dim=-1)
        o = torch.einsum("bkgqs,bksh->bkgqh", p.to(q.dtype), vh)
        o = o / torch.clamp(l, min=1e-30)[..., None].to(q.dtype)
        outs.append(o.permute(0, 3, 1, 2, 4)[:, :n])    # [B,n,K,G,hd]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def _check_attention(attention: str) -> None:
    if attention not in ATTENTION:
        raise ValueError(f"attention must be one of {ATTENTION}, got "
                         f"{attention!r}")


def _attention(q, kh, vh, cfg: LMConfig, attention: str):
    """Causal self-attention of a prefill: q [B,S,H,hd], kh/vh
    [B,K,S,hd] contiguous -> [B,S,H,hd]."""
    if attention == "flash" and cfg.attn_window is None:
        out = flash_attention_op(q.transpose(1, 2).contiguous(), kh, vh,
                                 causal=True)
        return out.transpose(1, 2)
    if q.shape[1] >= cfg.chunked_attn_threshold:
        return _chunked_attention(q, kh, vh, cfg)
    return _plain_attention(q, kh, vh, cfg)


# ---------------------------------------------------------------------------
# FFN (dense SwiGLU / MoE)
# ---------------------------------------------------------------------------

def _dense_ffn(x, layer):
    h = torch.einsum("bsd,df->bsf", x, layer["w1"])
    g = torch.einsum("bsd,df->bsf", x, layer["w3"])
    return torch.einsum("bsf,fd->bsd", F.silu(h) * g, layer["w2"])


def moe_capacity(cfg: LMConfig, n_tokens: int) -> int:
    c = int(math.ceil(cfg.top_k * n_tokens * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, ((c + 7) // 8) * 8)   # pad to lane multiple


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort; ``torch.topk`` promises no order of ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _aux(probs, experts, E: int, dims):
    me = probs.mean(dim=dims)
    ce = F.one_hot(experts[..., 0], E).float().mean(dim=dims)
    return E * torch.sum(me * ce)


def _moe_ffn_grouped(x, layer, cfg: LMConfig):
    """The reference's grouped gather-only dispatch: tokens split into
    ``dispatch_groups`` groups, each sorted and packed into [E, Cg, D]
    by gathers alone."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = cfg.dispatch_groups
    Tg = B * S // G
    Cg = moe_capacity(cfg, Tg)
    dev = x.device
    xt = x.reshape(G, Tg, D)

    logits = torch.einsum("gtd,de->gte", xt.float(), layer["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, experts = _top_k(probs, k)                        # [G,Tg,k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_e = experts.reshape(G, Tg * k)
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(k)[None] \
        .expand(G, Tg * k)
    flat_g = gates.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)       # per-group sort
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    starts = torch.searchsorted(
        se, torch.arange(E, device=dev)[None].expand(G, E).contiguous())

    j = torch.arange(E * Cg, device=dev)
    slot_e, slot_c = j // Cg, j % Cg
    src_pos = starts[:, slot_e] + slot_c[None, :]            # [G, E*Cg]
    ends = torch.cat([starts[:, 1:],
                      torch.full((G, 1), Tg * k, device=dev,
                                 dtype=starts.dtype)], dim=1)
    slot_valid = src_pos < ends[:, slot_e]
    src_pos = torch.clamp(src_pos, max=Tg * k - 1)
    slot_token = torch.gather(st, 1, src_pos)                # [G, E*Cg]
    xd = torch.gather(xt, 1, slot_token[..., None].expand(-1, -1, D)) \
        * slot_valid[..., None].to(xt.dtype)
    xd = xd.reshape(G, E, Cg, D)

    h = torch.einsum("gecd,edf->gecf", xd, layer["w1"])
    g2 = torch.einsum("gecd,edf->gecf", xd, layer["w3"])
    ye = torch.einsum("gecf,efd->gecd", F.silu(h) * g2, layer["w2"])
    ye = ye.reshape(G, E * Cg, D)

    inv_order = torch.argsort(order, dim=1)                  # flat -> sorted
    pos_in_e = inv_order - torch.gather(starts, 1, flat_e)
    keep = pos_in_e < Cg
    slot_of = torch.clamp(flat_e * Cg + pos_in_e, max=E * Cg - 1)
    pulled = torch.gather(ye, 1, slot_of[..., None].expand(-1, -1, D)) \
        * (flat_g * keep).to(ye.dtype)[..., None]
    y = pulled.reshape(G, Tg, k, D).sum(dim=2)
    return y.reshape(B, S, D), _aux(probs, experts, E, (0, 1))


def _moe_ffn(x, layer, cfg: LMConfig):
    """Sort-based capacity dispatch -> grouped einsum -> combine."""
    if cfg.dispatch_groups:
        return _moe_ffn_grouped(x, layer, cfg)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = moe_capacity(cfg, T)
    dev = x.device
    xt = x.reshape(T, D)

    logits = torch.einsum("td,de->te", xt.float(), layer["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, experts = _top_k(probs, k)                        # [T,k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_e = experts.reshape(-1)                             # [T*k]
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = torch.bincount(se, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[se]
    keep = pos < C
    dest = torch.where(keep, se * C + pos, E * C)            # E*C = drop slot

    gathered = xt[st] * keep[:, None].to(xt.dtype)
    xd = torch.zeros(E * C + 1, D, dtype=xt.dtype, device=dev)
    xd[dest] = gathered                 # duplicates only at the drop slot
    xd = xd[:E * C].reshape(E, C, D)

    h = torch.einsum("ecd,edf->ecf", xd, layer["w1"])
    g = torch.einsum("ecd,edf->ecf", xd, layer["w3"])
    ye = torch.einsum("ecf,efd->ecd", F.silu(h) * g,
                      layer["w2"]).reshape(E * C, D)

    safe_dest = torch.clamp(dest, max=E * C - 1)
    contrib = ye[safe_dest] * (sg * keep).to(ye.dtype)[:, None]
    y = torch.zeros(T, D, dtype=x.dtype, device=dev).index_add_(0, st,
                                                                contrib)
    return y.reshape(B, S, D), _aux(probs, experts, E, 0)


def _ffn(x, layer, cfg: LMConfig):
    if cfg.is_moe:
        return _moe_ffn(x, layer, cfg)
    return _dense_ffn(x, layer), torch.zeros((), dtype=torch.float32,
                                             device=x.device)


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def _layer(params: Dict, li: int) -> Dict:
    return {k: v[li] for k, v in params["layers"].items()}


def _embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(embed, tokens, mode="clip")``: ids clipped to the
    (padded) table."""
    table = params["embed"]
    return table[tokens.long().clamp(0, table.shape[0] - 1)]


def _unembed(params: Dict, cfg: LMConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def layer_forward(x, layer, cfg: LMConfig, attention: str = "flash"):
    """One transformer block on a per-layer param slice: x [B,S,D] ->
    (x', aux, (kh, vh)) with kh/vh [B,K,S,hd], the head-major keys and
    values the cache holds."""
    S = x.shape[1]
    h = rms_norm(x, layer["ln1"])
    q, k, v = _qkv(h, layer, cfg)
    pos = torch.arange(S, device=x.device)[None, :]
    q = rope(q, pos, cfg.rope_base)
    k = rope(k, pos, cfg.rope_base)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    attn = _attention(q, kh, vh, cfg, attention)
    x = x + torch.einsum("bqnh,nhd->bqd", attn, layer["wo"])
    ff, aux = _ffn(rms_norm(x, layer["ln2"]), layer, cfg)
    return x + ff, aux, (kh, vh)


def layer_decode(x, layer, k_cache, v_cache, pos: int, cfg: LMConfig,
                 attention: str = "flash"):
    """One decode step through one layer: x [B,D]; k_cache/v_cache
    [B,K,S,hd], written at ``pos`` in place.  Returns x'."""
    h = rms_norm(x[:, None], layer["ln1"])
    q, k, v = _qkv(h, layer, cfg)                      # q [B,1,H,hd]
    p = torch.full((1, 1), pos, device=x.device)
    q = rope(q, p, cfg.rope_base)
    k = rope(k, p, cfg.rope_base)
    k_cache[:, :, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v[:, 0].to(v_cache.dtype)
    if attention == "flash" and cfg.attn_window is None:
        attn = flash_attention_op(q.transpose(1, 2).contiguous(), k_cache,
                                  v_cache, causal=True, sk_valid=pos + 1)
        attn = attn.transpose(1, 2)                    # [B,1,H,hd]
    else:
        attn = _plain_attention(q, k_cache, v_cache, cfg, q_offset=pos)
    x = x + torch.einsum("bqnh,nhd->bqd", attn, layer["wo"])[:, 0]
    ff, _ = _ffn(rms_norm(x[:, None], layer["ln2"]), layer, cfg)
    return x + ff[:, 0]


def forward(params: Dict, tokens: torch.Tensor, cfg: LMConfig, *,
            attention: str = "flash") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (logits [B,S,V], aux_loss scalar)."""
    _check_attention(attention)
    x = _embed(params, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(cfg.n_layers):
        x, a, _ = layer_forward(x, _layer(params, li), cfg, attention)
        aux_total = aux_total + a
    x = rms_norm(x, params["ln_f"])
    logits = torch.einsum("bsd,dv->bsv", x, _unembed(params, cfg))
    return logits, aux_total / cfg.n_layers


def causal_lm_loss(params: Dict, batch: Dict, cfg: LMConfig, *,
                   attention: str = "flash") -> torch.Tensor:
    """Causal-LM cross entropy over ``batch["tokens"]`` against
    ``batch["labels"]`` (negative labels are masked), padded vocab
    entries masked out, plus 0.01 × the MoE load-balance aux."""
    tokens, labels = batch["tokens"], batch["labels"]
    logits, aux = forward(params, tokens, cfg, attention=attention)
    logits = logits.float()
    V = cfg.padded_vocab
    vocab = torch.arange(V, device=logits.device)
    if V != cfg.vocab_size:
        logits = logits + torch.where(vocab >= cfg.vocab_size, NEG, 0.0)
    logz = torch.logsumexp(logits, dim=-1)
    onehot = vocab[None, None, :] == labels[..., None]
    gold = torch.where(onehot, logits, 0.0).sum(dim=-1)
    mask = (labels >= 0).float()
    loss = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# inference: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def init_cache_specs(cfg: LMConfig, batch: int, max_len: int) -> Dict:
    """ParamSpec tree for the KV cache, head-major: k and v are
    [L, B, K, max_len, hd] (the reference's are [L, B, max_len, K, hd];
    ``permute(0, 1, 3, 2, 4)`` maps one onto the other)."""
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    spec = ParamSpec((L, batch, K, max_len, hd),
                     ("layers", "batch", "kv_heads", "kv_seq", "head_dim"),
                     cfg.dtype, init="zeros")
    return {"k": spec, "v": spec}


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: Union[str, torch.device, None] = None) -> Dict:
    """A zero KV cache of ``init_cache_specs``' shape on the device."""
    dev = resolve_device(device)
    return {n: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for n, s in init_cache_specs(cfg, batch, max_len).items()}


def prefill(params: Dict, tokens: torch.Tensor, cfg: LMConfig, *,
            max_len: Optional[int] = None, attention: str = "flash",
            ) -> Tuple[torch.Tensor, Dict]:
    """Forward-only pass building the KV cache.

    Returns (last-position logits [B,V], cache {k,v: [L,B,K,max_len,hd]}).
    ``max_len`` (default S) preallocates room for the decode steps that
    follow; positions S and on are zeros."""
    _check_attention(attention)
    B, S = tokens.shape
    x = _embed(params, tokens)
    cache = init_cache(cfg, B, S if max_len is None else max_len, x.device)
    if cache["k"].shape[3] < S:
        raise ValueError(f"max_len {max_len} is shorter than the prompt's "
                         f"{S} tokens")
    for li in range(cfg.n_layers):
        x, _, (kh, vh) = layer_forward(x, _layer(params, li), cfg, attention)
        cache["k"][li, :, :, :S] = kh
        cache["v"][li, :, :, :S] = vh
    x = rms_norm(x[:, -1], params["ln_f"])
    return torch.einsum("bd,dv->bv", x, _unembed(params, cfg)), cache


def decode_one(params: Dict, cache: Dict, tokens: torch.Tensor, pos: int,
               cfg: LMConfig, *, attention: str = "flash",
               ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.

    tokens [B] int, ``pos`` a Python int (the current length, the same
    for every sequence; the reference traces it as a scalar).  Writes
    the step's keys and values at ``pos`` of the cache in place and
    returns (logits [B,V], the same cache)."""
    _check_attention(attention)
    S = cache["k"].shape[3]
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"pos {pos} outside the cache's {S} positions")
    x = _embed(params, tokens)                              # [B,D]
    for li in range(cfg.n_layers):
        x = layer_decode(x, _layer(params, li), cache["k"][li],
                         cache["v"][li], pos, cfg, attention)
    x = rms_norm(x, params["ln_f"])
    return torch.einsum("bd,dv->bv", x, _unembed(params, cfg)), cache

