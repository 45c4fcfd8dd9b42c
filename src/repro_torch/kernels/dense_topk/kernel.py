"""Launch wrapper of the hand-written Hopper ``dense_topk`` kernel.

The kernel (``csrc/dense_topk.cu``) replaces the reference's Pallas
kernel ``repro.kernels.dense_topk.kernel.dense_topk``.  It is built by
``kernels._build`` at first use and called through ``ctypes``.  This
wrapper takes CUDA tensors only: it checks them, allocates the outputs,
launches on the current stream and raises if the launch fails.
``dense_topk.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build

__all__ = ["dense_topk", "MAX_K", "TILE"]

TILE = 1024            # docs per tile (kTile in the source)
MAX_K = TILE           # the running top-k buffer is at most one tile
MAX_SMEM = 232448      # bytes of shared memory a block may use on sm_90
DTYPES = {torch.float32: "dense_topk_f32", torch.bfloat16: "dense_topk_bf16"}


@functools.cache
def _entry(symbol: str):
    fn = getattr(_build.load("dense_topk"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dense_topk(q: torch.Tensor, c: torch.Tensor, *, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [Q, d], c [N, d] on one CUDA device, both float32 or both
    bfloat16 (upcast to fp32 in the kernel), contiguous; 1 <= k <=
    min(N, 1024).  Returns ``(vals [Q, k] f32, idxs [Q, k] i32)``,
    ordered by descending score, then ascending doc index."""
    if q.device.type != "cuda" or c.device != q.device:
        raise ValueError(f"dense_topk needs q and c on one CUDA device, "
                         f"got {q.device} and {c.device}")
    if q.dtype not in DTYPES or c.dtype != q.dtype:
        raise TypeError(f"dense_topk takes float32 or bfloat16 q and c of "
                        f"one dtype, got {q.dtype} and {c.dtype}")
    if q.ndim != 2 or c.ndim != 2 or q.shape[1] != c.shape[1]:
        raise ValueError(f"dense_topk needs q [Q, d] and c [N, d], got "
                         f"{tuple(q.shape)} and {tuple(c.shape)}")
    if not (q.is_contiguous() and c.is_contiguous()):
        raise ValueError("dense_topk needs contiguous q and c")
    (n_q, d), n_docs = q.shape, c.shape[0]
    if n_q < 1 or n_docs < 1 or d < 1:
        raise ValueError(f"dense_topk needs non-empty q and c, got "
                         f"{tuple(q.shape)} and {tuple(c.shape)}")
    if not 1 <= k <= min(n_docs, MAX_K):
        raise ValueError(f"dense_topk takes 1 <= k <= min(N, {MAX_K}), "
                         f"got k={k} with N={n_docs}")
    k_pad = 1 << (k - 1).bit_length()
    if (k_pad + TILE) * 8 + d * 4 > MAX_SMEM:
        raise ValueError(f"dense_topk: d={d} needs more shared memory "
                         f"than a block has")
    vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    idxs = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    err = _entry(DTYPES[q.dtype])(
        q.data_ptr(), c.data_ptr(), vals.data_ptr(), idxs.data_ptr(),
        n_q, n_docs, d, k, k_pad, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_topk launch failed with CUDA error {err}")
    dense_topk.launches += 1
    return vals, idxs


dense_topk.launches = 0
