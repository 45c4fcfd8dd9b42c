"""Launch wrapper of the hand-written Hopper ``cachekey_hash`` kernel.

The kernel (``csrc/cachekey_hash.cu``) replaces the reference's Pallas
kernel ``repro.kernels.cachekey_hash.kernel.cachekey_hash``.  It is
built by ``kernels._build`` at first use and called through ``ctypes``.
This wrapper takes CUDA tensors only: it checks them, allocates the
output, launches on the current stream and raises if the launch fails.
``cachekey_hash.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

__all__ = ["cachekey_hash"]


@functools.cache
def _entry():
    fn = _build.load("cachekey_hash").cachekey_hash_u32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cachekey_hash(tokens: torch.Tensor) -> torch.Tensor:
    """tokens [N, L] int32, contiguous, on a CUDA device, N >= 1 ->
    [N, 2] int32 holding the two uint32 FNV-1a lanes' bits."""
    if tokens.device.type != "cuda":
        raise ValueError(f"cachekey_hash needs a CUDA tensor, got "
                         f"{tokens.device}")
    if tokens.dtype != torch.int32 or tokens.ndim != 2:
        raise TypeError(f"cachekey_hash takes int32 tokens [N, L], got "
                        f"{tokens.dtype} {tuple(tokens.shape)}")
    if not tokens.is_contiguous():
        raise ValueError("cachekey_hash needs contiguous tokens")
    n_rows, n_cols = tokens.shape
    if n_rows < 1 or n_rows * max(n_cols, 1) >= 1 << 31:
        raise ValueError(f"cachekey_hash takes 1 <= N and N*L < 2^31, got "
                         f"{tuple(tokens.shape)}")
    out = torch.empty((n_rows, 2), dtype=torch.int32, device=tokens.device)
    err = _entry()(tokens.data_ptr(), out.data_ptr(), n_rows, n_cols,
                   tokens.device.index,
                   torch.cuda.current_stream(tokens.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cachekey_hash launch failed with CUDA error "
                           f"{err}")
    cachekey_hash.launches += 1
    return out


cachekey_hash.launches = 0
