"""Gradient compression with error feedback (distributed optimization).

Counterpart of ``repro.distrib.compression``.  Two compressors, both
with EF (error-feedback) accumulators so the quantization error is
re-injected next step (Karimireddy et al., arXiv:1901.09847 — EF-SGD;
1-bit Adam lineage):

* ``int8`` — per-tensor symmetric int8 quantization (32→8 bits on the
  wire: 4× reduce-scatter volume); ``torch.round`` rounds half to even,
  as ``jnp.round`` does;
* ``topk`` — magnitude top-k sparsification (k fraction kept); every
  element at or above the k-th magnitude is kept, so ties keep more
  than k, as in the reference.

The compress/decompress pair is applied *around the collective*: in a
deployment the int8 payload is what crosses the interconnect.  In a
single process the arithmetic (and its effect on training) is exercised
end to end.  Trees are nested dicts of tensors; the EF state is fp32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from ..models.common import _leaves, _unflatten

__all__ = ["CompressionConfig", "init_ef_state", "compress_grads",
           "wire_bytes"]


@dataclass(frozen=True)
class CompressionConfig:
    method: str = "none"        # none | int8 | topk
    topk_fraction: float = 0.01
    error_feedback: bool = True


def init_ef_state(params) -> Any:
    return _unflatten((path, torch.zeros_like(p, dtype=torch.float32))
                      for path, p in _leaves(params))


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _topk_roundtrip(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(g.abs() >= thresh, g, 0.0)


def compress_grads(grads, ef_state, cfg: CompressionConfig) -> Tuple[Any, Any]:
    """Returns (decompressed grads as seen post-collective, new EF state)."""
    if cfg.method == "none":
        return grads, ef_state
    if cfg.method not in ("int8", "topk"):
        raise ValueError(cfg.method)

    def one(g, e):
        g32 = g.float()
        target = g32 + (e if cfg.error_feedback else 0.0)
        if cfg.method == "int8":
            sent = _int8_roundtrip(target)
        else:
            sent = _topk_roundtrip(target, cfg.topk_fraction)
        new_e = target - sent if cfg.error_feedback else e
        return sent.to(g.dtype), new_e

    flat_e = dict(_leaves(ef_state))
    out_g, out_e = [], []
    for path, g in _leaves(grads):
        sent, new_e = one(g, flat_e[path])
        out_g.append((path, sent))
        out_e.append((path, new_e))
    return _unflatten(out_g), _unflatten(out_e)


def wire_bytes(params, cfg: CompressionConfig) -> int:
    """Bytes a gradient all-reduce would move per step under cfg."""
    n = sum(math.prod(p.shape) for _, p in _leaves(params))
    if cfg.method == "int8":
        return n            # 1 byte/elem
    if cfg.method == "topk":
        keep = int(n * cfg.topk_fraction)
        return keep * 8     # value fp32 + index int32
    return n * 4
