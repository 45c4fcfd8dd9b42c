"""Launch wrapper of the hand-written Hopper ``embedding_bag`` kernel.

The kernel (``csrc/embedding_bag.cu``) replaces the reference's Pallas
kernel ``repro.kernels.embedding_bag.kernel.embedding_bag``.  It is
built by ``kernels._build`` at first use and called through ``ctypes``.
This wrapper takes CUDA tensors only: it checks them, casts the weights
to the table's dtype (as the reference kernel does), allocates the
output, launches on the current stream and raises if the launch fails.
``embedding_bag.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build

__all__ = ["embedding_bag"]

DTYPES = {torch.float32: "embedding_bag_f32",
          torch.bfloat16: "embedding_bag_bf16"}


@functools.cache
def _entry(symbol: str):
    fn = getattr(_build.load("embedding_bag"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table [V, d] float32 or bfloat16, ids [B, L] int32 and weights
    [B, L] (any float dtype; None = all ones) on one CUDA device,
    contiguous, V, d, B >= 1 -> [B, d] in the table's dtype: per bag
    the weighted sum of its rows (ids clipped to [0, V-1]), accumulated
    in fp32."""
    if table.device.type != "cuda" or ids.device != table.device or (
            weights is not None and weights.device != table.device):
        raise ValueError(f"embedding_bag needs table, ids and weights on "
                         f"one CUDA device, got {table.device}, "
                         f"{ids.device} and "
                         f"{None if weights is None else weights.device}")
    if table.dtype not in DTYPES or ids.dtype != torch.int32:
        raise TypeError(f"embedding_bag takes a float32 or bfloat16 table "
                        f"and int32 ids, got {table.dtype} and {ids.dtype}")
    if table.ndim != 2 or ids.ndim != 2 or (
            weights is not None and weights.shape != ids.shape):
        w_shape = None if weights is None else tuple(weights.shape)
        raise ValueError(f"embedding_bag needs table [V, d], ids [B, L] "
                         f"and weights [B, L] or None, got "
                         f"{tuple(table.shape)}, {tuple(ids.shape)} and "
                         f"{w_shape}")
    if weights is not None and not weights.is_floating_point():
        raise TypeError(f"embedding_bag takes float weights, got "
                        f"{weights.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("embedding_bag needs a contiguous table and ids")
    (n_rows, d), (n_bags, bag_len) = table.shape, ids.shape
    if n_rows < 1 or d < 1 or n_bags < 1:
        raise ValueError(f"embedding_bag needs V, d, B >= 1, got table "
                         f"{tuple(table.shape)} and ids {tuple(ids.shape)}")
    if weights is not None:
        weights = weights.to(table.dtype).contiguous()
    out = torch.empty((n_bags, d), dtype=table.dtype, device=table.device)
    err = _entry(DTYPES[table.dtype])(
        table.data_ptr(), ids.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        n_rows, d, n_bags, bag_len, table.device.index,
        torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed with CUDA error "
                           f"{err}")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
