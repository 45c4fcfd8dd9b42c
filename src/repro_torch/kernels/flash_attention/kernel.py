"""Launch wrapper of the hand-written Hopper ``flash_attention`` kernel.

The kernel (``csrc/flash_attention.cu``) replaces the reference's Pallas
kernel ``repro.kernels.flash_attention.kernel.flash_attention``
(forward).  It is built by ``kernels._build`` at first use and called
through ``ctypes``.  This wrapper takes CUDA tensors only: it checks
them, allocates the output, launches on the current stream and raises
if the launch fails.  ``flash_attention.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
import torch

from .. import _build

__all__ = ["flash_attention", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128     # a lane owns at most 4 of a row's output columns
DTYPES = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


@functools.cache
def _entry(symbol: str):
    fn = getattr(_build.load("flash_attention"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B, H, Sq, hd], k and v [B, K, Sk, hd] on one CUDA device, all
    float32 or all bfloat16, contiguous; H a multiple of K; 1 <= hd <=
    128.  If ``causal``, key j is masked for query row i when
    j > i + Sk - Sq.  Scores are scaled by 1/sqrt(hd).  Returns
    [B, H, Sq, hd] in q's dtype."""
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"flash_attention needs q, k and v on one CUDA "
                         f"device, got {q.device}, {k.device} and "
                         f"{v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k "
                        f"and v of one dtype, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention needs q [B, H, Sq, hd] and k, v "
                         f"[B, K, Sk, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if min(B, H, K, Sq) < 1 or H % K:
        raise ValueError(f"flash_attention needs B, H, K, Sq >= 1 and H a "
                         f"multiple of K, got q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes 1 <= hd <= {MAX_HEAD_DIM}, "
                         f"got {hd}: a larger head needs more shared memory "
                         f"and registers than a block has")
    out = torch.empty_like(q)
    err = _entry(DTYPES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, K, Sq, Sk, hd, 1.0 / math.sqrt(hd), int(causal),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
