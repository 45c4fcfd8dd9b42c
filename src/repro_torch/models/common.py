"""Shared model machinery: parameter specs, initialisation, the weight
bridge and the numerics the models share.

Counterpart of ``repro.models.common``.  Parameters are nested dicts of
tensors in the reference's layout (``wq [L, D, H, hd]``,
``wo [L, H, hd, D]``, ...), so ``params_from_numpy`` can take the
reference's parameter tree and both packages compute from identical
weights.  Native initialisation draws from a ``torch.Generator``; it
cannot reproduce the reference's ``jax.random`` bits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["ParamSpec", "init_params", "params_from_numpy", "rms_norm"]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "lecun"          # lecun | he | embed | zeros | ones | normal
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"{self.shape} vs {self.logical_axes}")


def _std(spec: ParamSpec) -> float:
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    if spec.init in ("embed", "normal"):
        return spec.init_scale
    if spec.init == "he":
        return spec.init_scale * math.sqrt(2.0 / fan_in)
    if spec.init == "lecun":
        return spec.init_scale * math.sqrt(1.0 / fan_in)
    raise ValueError(f"unknown init {spec.init!r}")


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in sorted-key order, the order jax.tree uses."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.extend(_leaves(val, prefix + (key,)))
        else:
            out.append((prefix + (key,), val))
    return out


def _unflatten(pairs) -> Dict:
    out: Dict = {}
    for path, val in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return out


def init_params(specs: Dict, generator: torch.Generator,
                device: Union[str, torch.device]) -> Dict:
    """Materialise a spec tree.  Draws on the generator's device (the
    CPU for a default ``torch.Generator``) in sorted-key order, then
    moves each tensor to ``device``, so the weights do not depend on
    the device they land on."""
    vals = []
    for path, spec in _leaves(specs):
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=spec.dtype)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=spec.dtype)
        else:
            t = (torch.randn(spec.shape, generator=generator,
                             dtype=torch.float32) * _std(spec)).to(spec.dtype)
        vals.append((path, t.to(device)))
    return _unflatten(vals)


def params_from_numpy(tree: Dict, device: Union[str, torch.device]) -> Dict:
    """The weight bridge: a nested dict of arrays (the reference's
    parameter tree, converted with ``np.asarray``) -> the same nested
    dict of tensors on ``device``, layout and dtype unchanged."""
    return _unflatten(
        (path, torch.from_numpy(np.array(leaf, copy=True)).to(device))
        for path, leaf in _leaves(tree))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation of the mean square, applied in
    ``x``'s dtype (as ``repro.models.common.rms_norm``)."""
    var = x.square().mean(dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale
