"""The cross-encoder's forward pass in plain PyTorch float32.

A frozen copy of the equations the port states for its encoder
(pre-RMSNorm blocks without biases, tanh GELU, masked mean pool, linear
head), written without its padding: each pair runs at its own length,
in blocks of similar lengths, with padded keys masked out of the
softmax.  TF32 is switched off, so every product is float32.

Weights are a nested dict in the layout the benchmark draws them in:
``embed [V, D]``, ``pos [S, D]``, ``layers/{ln1, ln2} [L, D]``,
``layers/{wq, wk, wv} [L, D, H, hd]``, ``layers/wo [L, H, hd, D]``,
``layers/w1 [L, D, F]``, ``layers/w2 [L, F, D]``, ``ln_f [D]``,
``w_score [D, 1]``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["score_pairs"]


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def _forward(w: Dict, ids: torch.Tensor, lengths: torch.Tensor
             ) -> torch.Tensor:
    """ids [B, S] (0 past each length) -> scores [B]."""
    B, S = ids.shape
    real = torch.arange(S, device=ids.device)[None, :] < lengths[:, None]
    x = w["embed"][ids.long()] + w["pos"][:S][None]
    lay = w["layers"]
    n_layers, _, H, hd = lay["wq"].shape
    key_mask = (~real)[:, None, None, :]
    for i in range(n_layers):
        h = _rms(x, lay["ln1"][i])
        q = torch.einsum("bsd,dnh->bnsh", h, lay["wq"][i])
        k = torch.einsum("bsd,dnh->bnsh", h, lay["wk"][i])
        v = torch.einsum("bsd,dnh->bnsh", h, lay["wv"][i])
        att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        att = torch.softmax(att.masked_fill(key_mask, float("-inf")), -1)
        o = torch.einsum("bnsh,nhd->bsd", att @ v, lay["wo"][i])
        x = x + o
        h = _rms(x, lay["ln2"][i])
        x = x + _gelu(h @ lay["w1"][i]) @ lay["w2"][i]
    x = _rms(x, w["ln_f"])
    m = real[..., None].to(x.dtype)
    pooled = (x * m).sum(1) / m.sum(1)
    return (pooled @ w["w_score"])[:, 0]


def score_pairs(weights: Dict, pairs: Sequence[List[int]],
                tokens_per_block: int = 1 << 17) -> np.ndarray:
    """Scores (float64) of token-id lists, each at its own length."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = weights["embed"].device
    n = len(pairs)
    out = np.empty(n, dtype=np.float64)
    order = sorted(range(n), key=lambda i: len(pairs[i]))
    lo = 0
    with torch.inference_mode():
        while lo < n:
            hi = lo
            while hi < n and (hi - lo + 1) * len(pairs[order[hi]]) \
                    <= tokens_per_block:
                hi += 1
            hi = max(hi, lo + 1)
            idx = order[lo:hi]
            S = max(len(pairs[i]) for i in idx)
            ids = np.zeros((len(idx), S), dtype=np.int64)
            lens = np.empty(len(idx), dtype=np.int64)
            for r, i in enumerate(idx):
                ids[r, :len(pairs[i])] = pairs[i]
                lens[r] = len(pairs[i])
            s = _forward(weights, torch.from_numpy(ids).to(dev),
                         torch.from_numpy(lens).to(dev))
            out[idx] = s.double().cpu().numpy()
            lo = hi
    return out
