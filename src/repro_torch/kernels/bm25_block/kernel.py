"""Launch wrapper of the hand-written Hopper ``bm25_block`` kernel.

The kernel (``csrc/bm25_block.cu``) replaces the reference's Pallas
kernel ``repro.kernels.bm25_block.kernel.bm25_block``.  It is built by
``kernels._build`` at first use and called through ``ctypes``.  This
wrapper takes CUDA tensors only: it checks them, allocates the output,
launches on the current stream and raises if the launch fails.
``bm25_block.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

__all__ = ["bm25_block"]


@functools.cache
def _entry():
    fn = _build.load("bm25_block").bm25_block_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bm25_block(tf: torch.Tensor, idf: torch.Tensor, doc_len: torch.Tensor,
               *, k1: float = 1.2, b: float = 0.75,
               avg_dl: float = 1.0) -> torch.Tensor:
    """tf [T, D], idf [T] and doc_len [D], float32 and contiguous on one
    CUDA device, T >= 0, D >= 1 -> scores [D] float32."""
    if tf.device.type != "cuda" or idf.device != tf.device or \
            doc_len.device != tf.device:
        raise ValueError(f"bm25_block needs tf, idf and doc_len on one CUDA "
                         f"device, got {tf.device}, {idf.device} and "
                         f"{doc_len.device}")
    if not all(x.dtype == torch.float32 for x in (tf, idf, doc_len)):
        raise TypeError(f"bm25_block takes float32 tf, idf and doc_len, got "
                        f"{tf.dtype}, {idf.dtype} and {doc_len.dtype}")
    if tf.ndim != 2 or idf.shape != tf.shape[:1] or \
            doc_len.shape != tf.shape[1:]:
        raise ValueError(f"bm25_block needs tf [T, D], idf [T] and doc_len "
                         f"[D], got {tuple(tf.shape)}, {tuple(idf.shape)} "
                         f"and {tuple(doc_len.shape)}")
    if not all(x.is_contiguous() for x in (tf, idf, doc_len)):
        raise ValueError("bm25_block needs contiguous tf, idf and doc_len")
    n_terms, n_docs = tf.shape
    if n_docs < 1:
        raise ValueError("bm25_block needs D >= 1")
    out = torch.empty(n_docs, dtype=torch.float32, device=tf.device)
    err = _entry()(tf.data_ptr(), idf.data_ptr(), doc_len.data_ptr(),
                   out.data_ptr(), n_terms, n_docs, k1, b, avg_dl,
                   tf.device.index,
                   torch.cuda.current_stream(tf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bm25_block launch failed with CUDA error {err}")
    _build.count_launches(bm25_block, 1)
    return out


bm25_block.launches = 0
