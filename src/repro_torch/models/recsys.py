"""RecSys model family: DLRM, DCN-v2, MIND, two-tower retrieval, in PyTorch.

Counterpart of ``repro.models.recsys``.  Parameters are nested dicts of
tensors in the reference's layout (``load_params`` bridges the
reference's numpy tree or draws from a ``torch.Generator``); every
function takes the tensors' device.  Numerics that must match the
reference:

* every lookup clamps its ids to ``[0, V-1]``, as ``jnp.take(...,
  mode="clip")`` does: torch's indexing would raise on the CPU, and
  assert on the card, for an id out of range;
* MIND's routing logits start from ``jax.random.normal(jax.random.key(17),
  (1, K, L))``, a constant of the function that no weight bridge
  carries; ``_jax_threefry`` draws the same numbers without JAX;
* the routing logits and the squash are in fp32, whatever the
  parameters' dtype, as the reference computes them.

``embedding_bag`` is the one entry point to the ``embedding_bag``
kernel: ``embedding_bag_op`` sums each bag (the CUDA kernel on the card,
its plain version on the CPU) and the ``mean`` combiner divides here by
``max(Σmask, 1)``, the reference's denominator, not by the op's fused
``max(Σw, 1e-9)``.  As in the reference, no model's forward pass calls
it: MIND's history is a masked gather feeding a bilinear map, not a bag
sum.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels.embedding_bag import embedding_bag_op
from . import _jax_threefry
from .common import (ParamSpec, diagonal, is_split, load_weights, linear,
                     logsumexp, matmul, plain, replicate_like, take_rows)

__all__ = ["CRITEO_VOCABS", "RecsysConfig", "recsys_param_specs",
           "embedding_bag", "dlrm_forward", "dcn_forward", "mind_forward",
           "two_tower_embed", "recsys_train_loss", "recsys_serve",
           "two_tower_retrieval_scores", "load_params"]

#: Criteo-Kaggle per-field categorical cardinalities (public DLRM config)
CRITEO_VOCABS: Tuple[int, ...] = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)

#: the seed of MIND's fixed routing-logit init (the reference's key)
ROUTING_SEED = 17


def _pad512(v: int) -> int:
    return ((v + 511) // 512) * 512


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                      # dlrm | dcn | mind | two_tower
    embed_dim: int
    n_dense: int = 0
    vocab_sizes: Tuple[int, ...] = ()
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    n_cross_layers: int = 0
    deep_mlp: Tuple[int, ...] = ()
    tower_mlp: Tuple[int, ...] = ()
    n_interests: int = 0
    capsule_iters: int = 3
    hist_len: int = 50
    item_vocab: int = 1_000_000
    user_vocab: int = 2_000_000
    dtype: torch.dtype = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _mlp_specs(dims: Sequence[int], prefix: str, dt) -> Dict[str, ParamSpec]:
    out = {}
    for i in range(len(dims) - 1):
        out[f"{prefix}_w{i}"] = ParamSpec(
            (dims[i], dims[i + 1]), ("mlp_in", "mlp_out"), dt, init="he")
        out[f"{prefix}_b{i}"] = ParamSpec(
            (dims[i + 1],), ("mlp_out",), dt, init="zeros")
    return out


def _mlp(x, params, prefix: str, n: int, final_act: bool = False):
    for i in range(n):
        x = linear(x, params[f"{prefix}_w{i}"], params[f"{prefix}_b{i}"])
        if i < n - 1 or final_act:
            x = F.relu(x)
    return x


def _table_spec(rows: int, d: int, dt) -> ParamSpec:
    return ParamSpec((_pad512(rows), d), ("table_rows", "table_dim"), dt,
                     init="embed", init_scale=1.0 / math.sqrt(d))


def recsys_param_specs(cfg: RecsysConfig) -> Dict:
    dt = cfg.dtype
    d = cfg.embed_dim
    specs: Dict[str, Any] = {}
    if cfg.kind in ("dlrm", "dcn"):
        specs["tables"] = {f"t{i}": _table_spec(v, d, dt)
                           for i, v in enumerate(cfg.vocab_sizes)}
    if cfg.kind == "dlrm":
        bot = (cfg.n_dense,) + cfg.bot_mlp
        n_int = cfg.n_sparse + 1
        d_inter = n_int * (n_int - 1) // 2 + cfg.bot_mlp[-1]
        top = (d_inter,) + cfg.top_mlp
        specs.update(_mlp_specs(bot, "bot", dt))
        specs.update(_mlp_specs(top, "top", dt))
    elif cfg.kind == "dcn":
        d0 = cfg.n_dense + cfg.n_sparse * d
        for i in range(cfg.n_cross_layers):
            specs[f"cross_w{i}"] = ParamSpec((d0, d0), ("mlp_in", "mlp_out"),
                                             dt, init="lecun")
            specs[f"cross_b{i}"] = ParamSpec((d0,), ("mlp_out",), dt,
                                             init="zeros")
        specs.update(_mlp_specs((d0,) + cfg.deep_mlp, "deep", dt))
        specs["logit_w"] = ParamSpec((d0 + cfg.deep_mlp[-1], 1),
                                     ("mlp_in", None), dt)
    elif cfg.kind == "mind":
        specs["item_embed"] = _table_spec(cfg.item_vocab, d, dt)
        specs["S"] = ParamSpec((d, d), ("mlp_in", "mlp_out"), dt)
        specs.update(_mlp_specs((d, d * 2, d), "interest", dt))
    elif cfg.kind == "two_tower":
        specs["user_embed"] = _table_spec(cfg.user_vocab, d, dt)
        specs["item_embed"] = _table_spec(cfg.item_vocab, d, dt)
        specs.update(_mlp_specs((d,) + cfg.tower_mlp, "user_tower", dt))
        specs.update(_mlp_specs((d,) + cfg.tower_mlp, "item_tower", dt))
    else:
        raise ValueError(cfg.kind)
    return specs


def load_params(cfg: RecsysConfig, seed: int = 0, *,
                params: Optional[Dict] = None,
                device: Union[str, torch.device, None] = None
                ) -> Tuple[Dict, Tuple]:
    """(weights on the device, their source), as ``lm.load_params``:
    bridged from a nested dict of numpy arrays, or drawn from
    ``torch.Generator().manual_seed(seed)`` on the host.  At full width
    (DLRM's tables are 8.65 GB) call ``init_params`` with a CUDA
    generator instead, which draws on the card."""
    return load_weights(recsys_param_specs(cfg), seed, params=params,
                        device=device)


# ---------------------------------------------------------------------------
# embedding substrate
# ---------------------------------------------------------------------------

def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0, mode="clip")``."""
    return take_rows(table, ids)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  combiner: str = "sum") -> torch.Tensor:
    """EmbeddingBag: ids [B, L] -> [B, dim] (sum/mean over the bag).

    The bag sum goes through ``embedding_bag_op`` (one ``embedding_bag``
    kernel launch on the card); ``mean`` then divides by the bag's mask
    sum (or L) held at 1 or more, as the reference does."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner is 'sum' or 'mean', not {combiner!r}")
    out = embedding_bag_op(table, ids.to(torch.int32), mask, combiner="sum")
    if combiner == "mean":
        denom = (mask.sum(dim=1, keepdim=True) if mask is not None
                 else torch.full((1, 1), ids.shape[1], device=out.device))
        out = out / torch.clamp(denom.to(out.dtype), min=1.0)
    return out


def _field_embeds(tables: Dict[str, torch.Tensor],
                  sparse_ids: torch.Tensor) -> torch.Tensor:
    """sparse_ids [B, n_fields] (one id per field) -> [B, n_fields, d]."""
    return torch.stack([_take(tables[f"t{i}"], sparse_ids[:, i])
                        for i in range(sparse_ids.shape[1])], dim=1)


# ---------------------------------------------------------------------------
# DLRM (arXiv:1906.00091) — dot interaction
# ---------------------------------------------------------------------------

def dlrm_forward(params: Dict, batch: Dict, cfg: RecsysConfig
                 ) -> torch.Tensor:
    dense, sparse = batch["dense"], batch["sparse"]     # [B,13], [B,26]
    bot = _mlp(dense, params, "bot", len(cfg.bot_mlp), final_act=True)
    emb = _field_embeds(params["tables"], sparse)       # [B, 26, d]
    z = torch.cat([bot[:, None, :], emb], dim=1)         # [B, 27, d]
    inter = torch.bmm(z, z.transpose(1, 2))
    n = z.shape[1]
    iu, ju = torch.triu_indices(n, n, 1, device=z.device)
    if is_split(inter):
        # the gather's backward is an index_put with a None index, which
        # DTensor cannot place: select the pairs by a one-hot product
        sel = F.one_hot(iu * n + ju, n * n).T.to(inter.dtype)
        flat = matmul(inter.flatten(1), replicate_like(sel, inter))
    else:
        flat = plain(lambda t: t[:, iu, ju], inter)      # [B, n(n-1)/2]
    x = torch.cat([bot, flat], dim=1)
    logit = _mlp(x, params, "top", len(cfg.top_mlp))
    return logit[:, 0]


# ---------------------------------------------------------------------------
# DCN-v2 (arXiv:2008.13535) — full-matrix cross layers ∥ deep MLP
# ---------------------------------------------------------------------------

def dcn_forward(params: Dict, batch: Dict, cfg: RecsysConfig) -> torch.Tensor:
    dense, sparse = batch["dense"], batch["sparse"]
    emb = _field_embeds(params["tables"], sparse)       # [B, 26, d]
    x0 = torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=1)
    x = x0
    for i in range(cfg.n_cross_layers):
        xw = linear(x, params[f"cross_w{i}"], params[f"cross_b{i}"])
        x = x0 * xw + x
    deep = _mlp(x0, params, "deep", len(cfg.deep_mlp), final_act=True)
    both = torch.cat([x, deep], dim=1)
    return matmul(both, params["logit_w"])[:, 0]


# ---------------------------------------------------------------------------
# MIND (arXiv:1904.08030) — multi-interest capsule routing
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def routing_init(K: int, L: int, device: torch.device) -> torch.Tensor:
    """The fixed routing-logit init [1, K, L] (fp32) on ``device``:
    ``jax.random.normal(jax.random.key(17), (1, K, L))``, which breaks
    the capsules' symmetry (paper §B2I).  Shared by every call: read,
    never written."""
    return torch.from_numpy(
        _jax_threefry.normal(ROUTING_SEED, (1, K, L))).to(device)


def mind_interests(params: Dict, hist_ids: torch.Tensor,
                   hist_mask: torch.Tensor, cfg: RecsysConfig
                   ) -> torch.Tensor:
    """B2I dynamic routing: history [B,L] -> K interest capsules [B,K,d]."""
    K = cfg.n_interests
    e = _take(params["item_embed"], hist_ids)              # [B,L,d]
    e = e * hist_mask[..., None].to(e.dtype)
    eS = torch.einsum("bld,de->ble", e, params["S"])       # shared bilinear
    B, L = hist_ids.shape
    b_logit = replicate_like(routing_init(K, L, e.device), e).expand(B, K, L)
    neg = torch.where(hist_mask > 0, 0.0, -1e30)[:, None, :]
    u = torch.zeros((B, K, e.shape[-1]), dtype=e.dtype, device=e.device)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b_logit + neg, dim=1)            # over capsules
        z = torch.einsum("bkl,ble->bke", w.to(eS.dtype), eS)
        z32 = z.float()
        sq = z32.square().sum(dim=-1, keepdim=True)
        u = (z32 * (sq / (1.0 + sq)) * torch.rsqrt(sq + 1e-9)).to(e.dtype)
        b_logit = b_logit + torch.einsum("bke,ble->bkl", u, eS).float()
    # per-capsule MLP head (H-layer in the paper)
    return _mlp(u, params, "interest", 2)


def mind_forward(params: Dict, batch: Dict, cfg: RecsysConfig
                 ) -> torch.Tensor:
    """In-batch sampled-softmax training logits [B, B]."""
    u = mind_interests(params, batch["hist_ids"], batch["hist_mask"], cfg)
    t = _take(params["item_embed"], batch["target_ids"])   # [B,d]
    # label-aware attention ≈ max over interests (pow→∞ limit)
    scores = torch.einsum("bkd,cd->bkc", u, t)             # [B,K,B]
    return scores.amax(dim=1)                              # [B,B]


# ---------------------------------------------------------------------------
# Two-tower retrieval (YouTube RecSys'19) — in-batch sampled softmax
# ---------------------------------------------------------------------------

def two_tower_embed(params: Dict, ids: torch.Tensor, tower: str,
                    cfg: RecsysConfig) -> torch.Tensor:
    table = params["user_embed" if tower == "user" else "item_embed"]
    out = _mlp(_take(table, ids), params, f"{tower}_tower",
               len(cfg.tower_mlp))
    return out / torch.clamp(torch.linalg.vector_norm(out, dim=-1,
                                                      keepdim=True), min=1e-6)


def two_tower_retrieval_scores(params: Dict, batch: Dict,
                               cfg: RecsysConfig) -> torch.Tensor:
    """1 query vs n_candidates: batched dot, not a loop."""
    u = two_tower_embed(params, batch["user_ids"], "user", cfg)     # [1,d']
    c = two_tower_embed(params, batch["cand_ids"], "item", cfg)     # [N,d']
    return matmul(u, c.T)


# ---------------------------------------------------------------------------
# unified train/serve entry points
# ---------------------------------------------------------------------------

def _bce_with_logits(logit: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    y = labels.float()
    z = logit.float()
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-z.abs())))


def _in_batch_softmax(logits: torch.Tensor) -> torch.Tensor:
    logz = logsumexp(logits, dim=-1)
    return (logz - diagonal(logits)).mean()


def recsys_train_loss(params: Dict, batch: Dict,
                      cfg: RecsysConfig) -> torch.Tensor:
    if cfg.kind == "dlrm":
        return _bce_with_logits(dlrm_forward(params, batch, cfg),
                                batch["labels"])
    if cfg.kind == "dcn":
        return _bce_with_logits(dcn_forward(params, batch, cfg),
                                batch["labels"])
    if cfg.kind == "mind":
        return _in_batch_softmax(mind_forward(params, batch, cfg).float())
    if cfg.kind == "two_tower":
        u = two_tower_embed(params, batch["user_ids"], "user", cfg)
        i = two_tower_embed(params, batch["item_ids"], "item", cfg)
        # logQ correction for in-batch sampling (uniform proposal)
        return _in_batch_softmax(matmul(u, i.T).float() * 10.0)
    raise ValueError(cfg.kind)


def recsys_serve(params: Dict, batch: Dict, cfg: RecsysConfig
                 ) -> torch.Tensor:
    if cfg.kind == "dlrm":
        return torch.sigmoid(dlrm_forward(params, batch, cfg))
    if cfg.kind == "dcn":
        return torch.sigmoid(dcn_forward(params, batch, cfg))
    if cfg.kind == "mind":
        u = mind_interests(params, batch["hist_ids"], batch["hist_mask"], cfg)
        t = _take(params["item_embed"], batch["target_ids"])
        return torch.einsum("bkd,bd->bk", u, t).amax(dim=1)
    if cfg.kind == "two_tower":
        return two_tower_retrieval_scores(params, batch, cfg)
    raise ValueError(cfg.kind)
