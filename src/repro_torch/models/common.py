"""Shared model machinery: parameter specs, initialisation, the weight
bridge and the numerics the models share.

Counterpart of ``repro.models.common``.  Parameters are nested dicts of
tensors in the reference's layout (``wq [L, D, H, hd]``,
``wo [L, H, hd, D]``, ...), so ``params_from_numpy`` can take the
reference's parameter tree and both packages compute from identical
weights.  Native initialisation draws from a ``torch.Generator``; it
cannot reproduce the reference's ``jax.random`` bits.

``shard_act`` is the identity: the reference's ``activation_sharding``
context, the only thing that changes it there, waits for the port's
distribution layer (meshes), so the port does not export it.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["ParamSpec", "init_params", "abstract_params", "logical_axes_tree",
           "count_params", "params_digest", "params_from_numpy", "rms_norm",
           "rope", "shard_act"]


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


def abstract_params(specs: Dict) -> Dict:
    """The spec tree as tensors on the ``meta`` device: shapes and dtypes,
    no memory (the reference's ``ShapeDtypeStruct`` tree)."""
    return _unflatten((path, torch.empty(spec.shape, dtype=spec.dtype,
                                         device="meta"))
                      for path, spec in _leaves(specs))


def logical_axes_tree(specs: Dict) -> Dict:
    return _unflatten((path, spec.logical_axes)
                      for path, spec in _leaves(specs))


def count_params(specs: Dict) -> int:
    return sum(math.prod(spec.shape) for _, spec in _leaves(specs))


def _tensor_of(leaf) -> torch.Tensor:
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: torch cannot take it
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree: Dict, device: Union[str, torch.device]) -> Dict:
    """The weight bridge: a nested dict of arrays (the reference's
    parameter tree, converted with ``np.asarray``) -> the same nested
    dict of tensors on ``device``, layout and dtype unchanged (bf16
    arrays of ``ml_dtypes`` included)."""
    return _unflatten((path, _tensor_of(leaf).to(device))
                      for path, leaf in _leaves(tree))


def params_digest(tree: Dict) -> str:
    """sha256 (hex) of a nested dict of arrays: every leaf's path, dtype,
    shape and bytes in sorted-key order.  Names bridged weights in
    provenance fingerprints."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        arr = np.ascontiguousarray(np.asarray(leaf))
        h.update(repr((path, arr.dtype.str, arr.shape)).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation of the mean square, applied in
    ``x``'s dtype (as ``repro.models.common.rms_norm``)."""
    var = x.square().mean(dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding. x: [..., seq, heads, d_head].

    cos/sin are computed in fp32 (tiny [S, d/2] tables), then applied in
    the activation's dtype, as ``repro.models.common.rope`` does."""
    half = x.shape[-1] // 2
    freq = (1.0 / base) ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    angles = positions.to(device=x.device, dtype=torch.float32)[..., None] \
        * freq                                            # [..., S, half]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)     # broadcast heads
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def shard_act(x: torch.Tensor, logical_axes) -> torch.Tensor:
    """The identity: no activation-sharding context exists in the port
    yet (see the module's docstring)."""
    del logical_axes
    return x
