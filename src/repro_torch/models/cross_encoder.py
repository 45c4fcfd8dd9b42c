"""Neural cross-encoder scorers as pipeline stages (MonoT5/DuoT5 roles).

Counterpart of ``repro.models.cross_encoder``.  ``MonoScorer`` is a
*pointwise* reranker: each (query, document) pair is scored
independently.  ``DuoScorer`` is a *pairwise* reranker whose score of a
document depends on the other retrieved documents for that query, so it
declares ``cacheable=False`` (paper §5).

Both wrap a small bidirectional encoder over hash-tokenized text.  The
weights live in an ``Encoder`` module; the forward pass is plain
functions on tensors.  Attention is a dense masked softmax in plain
PyTorch, as the reference computes it outside any kernel.  A scorer
call's tokens are cut to its sequence bucket (``seq_bucket``: the
longest pair rounded up to 32 columns, at most ``max_len``), its miss
batches run through ``BucketedRunner``'s power-of-two row buckets, and
each block through the process-wide ``CompileCache``: one CUDA graph per
(scorer class and config name, row and sequence bucket, device, config
and weight source), so a block's dozens of launches become one replay.
Numerics that must match the reference:

* GELU is the tanh approximation (``jax.nn.gelu``'s default);
* token ids are clamped to ``[0, V-1]`` (``jnp.take(mode="clip")``);
* the key-padding bias is ``-1e30``, added in fp32 before the softmax.

Deliberate differences from the reference:

* each call is computed at its own **sequence bucket**, the reference's
  at ``max_len``.  The columns cut are padding of every row: a padded
  key's softmax weight is exactly 0 (its bias is ``-1e30``), mean
  pooling divides by the unpadded count, and positions are ``pos[:S]``,
  so no score depends on them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..caching import compile_cache
from ..caching.bucketing import BucketedRunner, seq_bucket
from ..core import trace
from ..core.frame import ColFrame
from ..core.pipeline import Transformer, add_ranks
from ..ir.tokenizer import HashTokenizer
from .common import ParamSpec, load_weights, rms_norm

__all__ = ["EncoderConfig", "encoder_param_specs", "encoder_pooled",
           "encoder_score", "Encoder", "MonoScorer", "DuoScorer"]


@dataclass(frozen=True)
class EncoderConfig:
    name: str = "mono-ce"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 256
    vocab_size: int = 32768
    max_len: int = 64
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def encoder_param_specs(cfg: EncoderConfig) -> Dict:
    L, D, H, hd, F_, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    dt = cfg.dtype
    return {
        "embed": ParamSpec((V, D), ("vocab", "d_model"), dt, init="embed",
                           init_scale=0.02),
        "pos": ParamSpec((cfg.max_len, D), ("seq", "d_model"), dt,
                         init="embed", init_scale=0.02),
        "layers": {
            "ln1": ParamSpec((L, D), ("layers", "norm"), dt, init="ones"),
            "ln2": ParamSpec((L, D), ("layers", "norm"), dt, init="ones"),
            "wq": ParamSpec((L, D, H, hd),
                            ("layers", "d_model", "heads", "head_dim"), dt),
            "wk": ParamSpec((L, D, H, hd),
                            ("layers", "d_model", "heads", "head_dim"), dt),
            "wv": ParamSpec((L, D, H, hd),
                            ("layers", "d_model", "heads", "head_dim"), dt),
            "wo": ParamSpec((L, H, hd, D),
                            ("layers", "heads", "head_dim", "d_model_out"),
                            dt),
            "w1": ParamSpec((L, D, F_), ("layers", "d_model", "d_ff"), dt),
            "w2": ParamSpec((L, F_, D), ("layers", "d_ff", "d_model_out"), dt),
        },
        "ln_f": ParamSpec((D,), ("norm",), dt, init="ones"),
        "w_score": ParamSpec((D, 1), ("d_model", None), dt),
    }


def encoder_pooled(params: Dict, tokens: torch.Tensor,
                   cfg: EncoderConfig) -> torch.Tensor:
    """tokens [B, S] int -> masked mean of the final hidden states [B, D]."""
    B, S = tokens.shape
    mask = tokens != 0
    ids = tokens.long().clamp(0, cfg.vocab_size - 1)
    x = params["embed"][ids] + params["pos"][None, :S]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    bias = torch.where(mask, 0.0, -1e30).to(torch.float32)[:, None, None, :]
    layers = params["layers"]
    for i in range(cfg.n_layers):
        h = rms_norm(x, layers["ln1"][i])
        q = torch.einsum("bsd,dnh->bsnh", h, layers["wq"][i])
        k = torch.einsum("bsd,dnh->bsnh", h, layers["wk"][i])
        v = torch.einsum("bsd,dnh->bsnh", h, layers["wv"][i])
        scores = torch.einsum("bqnh,bsnh->bnqs", q, k).float()
        probs = torch.softmax(scores * scale + bias, dim=-1).to(x.dtype)
        attn = torch.einsum("bnqs,bsnh->bqnh", probs, v)
        x = x + torch.einsum("bqnh,nhd->bqd", attn, layers["wo"][i])
        h2 = rms_norm(x, layers["ln2"][i])
        ff = F.gelu(torch.einsum("bsd,df->bsf", h2, layers["w1"][i]),
                    approximate="tanh")
        x = x + torch.einsum("bsf,fd->bsd", ff, layers["w2"][i])
    x = rms_norm(x, params["ln_f"])
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def encoder_score(params: Dict, tokens: torch.Tensor,
                  cfg: EncoderConfig) -> torch.Tensor:
    """tokens [B, S] int (S ≤ max_len) -> scores [B] (bidirectional
    encoder)."""
    pooled = encoder_pooled(params, tokens, cfg)
    return torch.einsum("bd,do->bo", pooled, params["w_score"])[:, 0]


class Encoder(nn.Module):
    """The encoder's weights, frozen, on one device.

    ``params`` is a nested dict of numpy arrays in the reference's
    layout (bridged with ``params_from_numpy``); without it the weights
    are drawn from ``torch.Generator().manual_seed(seed)``."""

    def __init__(self, cfg: EncoderConfig, seed: int = 0, *,
                 params: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        self.cfg = cfg
        tree, self.weight_source = load_weights(
            encoder_param_specs(cfg), seed, params=params, device=device)
        frozen = lambda d: nn.ParameterDict(      # noqa: E731
            {k: nn.Parameter(v, requires_grad=False) for k, v in d.items()})
        self.top = frozen({k: v for k, v in tree.items() if k != "layers"})
        self.layers = frozen(tree["layers"])

    @property
    def tree(self) -> Dict:
        """The weights as the reference's nested dict."""
        return {**self.top, "layers": dict(self.layers)}

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return encoder_pooled(self.tree, tokens, self.cfg)


class _EncoderBase(Transformer):
    def __init__(self, cfg: EncoderConfig, seed: int = 0, *,
                 params: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.seed = seed
        self.encoder = Encoder(cfg, seed, params=params, device=device)
        self.tokenizer = HashTokenizer(cfg.vocab_size)
        self.invocations = 0     # pairs actually scored (cache accounting)
        self._runner = BucketedRunner(self._score_tokens, floor=8,
                                      max_bucket=1024)

    def _score_tokens(self, tokens: np.ndarray) -> np.ndarray:
        with trace.span("encoder.call", rows=len(tokens),
                        seq=tokens.shape[1]), \
                torch.inference_mode():
            with trace.span("encoder.h2d"):
                t = torch.from_numpy(tokens).to(self.encoder.device)
            with trace.span("encoder.replay"):
                out = compile_cache.default_compile_cache.call(
                    f"{type(self).__name__}:{self.cfg.name}", self._encode,
                    t, weight_source=(self.cfg,) + self.encoder.weight_source)
            with trace.span("encoder.sync"):    # the host waits on the card
                return out.cpu().numpy()

    def _encode(self, tokens: torch.Tensor) -> torch.Tensor:
        return encoder_score(self.encoder.tree, tokens, self.cfg)

    def fingerprint_extras(self) -> Tuple:
        """The weight source (native seed, or the digest of bridged
        weights): caches of this scorer never mix the two."""
        return ("weights",) + self.encoder.weight_source

    def _score_pairs(self, queries, texts) -> np.ndarray:
        with trace.span("encoder.tokenize", pairs=len(queries)):
            toks = np.stack([
                self.tokenizer.encode_pair(q, t, self.cfg.max_len)
                for q, t in zip(queries, texts)])
        seq = seq_bucket(np.count_nonzero(toks, axis=1).max(),
                         self.cfg.max_len)
        toks = np.ascontiguousarray(toks[:, :seq])
        self.invocations += len(queries)
        return np.asarray(self._runner(toks), dtype=np.float64)


class MonoScorer(_EncoderBase):
    """Pointwise neural reranker (R→R).  Cache-safe (paper §4.2)."""

    input_columns = frozenset({"qid", "query", "docno", "text"})
    key_columns = ("query", "docno")
    value_columns = ("score",)
    cacheable = True

    def transform(self, inp: ColFrame) -> ColFrame:
        if len(inp) == 0:
            return inp
        scores = self._score_pairs(inp["query"].tolist(),
                                   inp["text"].tolist())
        return add_ranks(inp.assign(score=scores))

    def signature(self):
        return ("MonoScorer", self.cfg.name, self.cfg.n_layers,
                self.cfg.d_model, self.seed)


class DuoScorer(_EncoderBase):
    """Pairwise reranker (R→R): score of d_i depends on the other
    candidates (sum over j of s(d_i ≻ d_j)).  NOT cacheable — §5."""

    input_columns = frozenset({"qid", "query", "docno", "text"})
    cacheable = False

    def __init__(self, cfg: EncoderConfig, seed: int = 1, max_docs: int = 10,
                 *, params: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__(cfg, seed, params=params, device=device)
        self.max_docs = int(max_docs)

    def transform(self, inp: ColFrame) -> ColFrame:
        if len(inp) == 0:
            return inp
        out_parts = []
        for (qid,), idx in inp.group_indices(["qid"]).items():
            grp = inp.take(idx)
            if "rank" in grp:
                grp = grp.sort_values(["rank"])
            grp = grp.head(self.max_docs)
            n = len(grp)
            texts = grp["text"].tolist()
            query = grp["query"][0]
            if n <= 1:
                out_parts.append(grp.assign(
                    score=np.zeros(n, dtype=np.float64)))
                continue
            qs, ts = [], []
            pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
            for i, j in pairs:
                qs.append(query)
                ts.append(texts[i] + " [VS] " + texts[j])
            s = self._score_pairs(qs, ts)
            agg = np.zeros(n, dtype=np.float64)
            for (i, j), v in zip(pairs, s):
                agg[i] += v          # wins of i over j
                agg[j] -= v
            out_parts.append(grp.assign(score=agg))
        return add_ranks(ColFrame.concat(out_parts))

    def signature(self):
        return ("DuoScorer", self.cfg.name, self.cfg.n_layers,
                self.cfg.d_model, self.seed, self.max_docs)
