"""``cachekey_hash_op``: dispatch by device (and the reference's row
padding on the plain path), plus the host digest the kernel must equal.

The tensor's device decides: CUDA tensors go to the hand-written
kernel (which raises on anything it cannot take), CPU tensors to the
plain version.  Nothing falls back from one to the other.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .kernel import cachekey_hash
from .ref import FNV_OFFSET, FNV_PRIME, LANE2_OFFSET, cachekey_hash_ref

__all__ = ["cachekey_hash_op", "host_cachekey"]


def cachekey_hash_op(tokens: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [N, L] int32 -> [N, 2] int32 holding the uint32 lanes'
    bits, written to ``out`` ([N, 2] int32) when given.  The plain
    version pads rows to the reference's block (256 rows, or max(8, N)
    below 256) and cuts the padding off again; the kernel masks its
    ragged edge and takes the rows as they are."""
    if tokens.dtype != torch.int32 or tokens.ndim != 2:
        raise TypeError(f"cachekey_hash_op takes int32 tokens [N, L], got "
                        f"{tokens.dtype} {tuple(tokens.shape)}")
    n = tokens.shape[0]
    if n == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=tokens.device)
    if tokens.device.type == "cuda":
        return cachekey_hash(tokens.contiguous(), out)
    if tokens.device.type != "cpu":
        raise ValueError(f"cachekey_hash_op runs on cuda or cpu, not "
                         f"{tokens.device}")
    bn = 256 if n >= 256 else max(8, n)
    pad = (-n) % bn
    tp = F.pad(tokens, (0, 0, 0, pad)) if pad else tokens.contiguous()
    res = cachekey_hash_ref(tp)[:n]
    return res if out is None else out.copy_(res)


def host_cachekey(token_row: np.ndarray) -> bytes:
    """Host-side digest identical to the kernel: the two lanes as 4
    little-endian bytes each."""
    h0, h1 = FNV_OFFSET, LANE2_OFFSET
    for b in np.asarray(token_row, dtype=np.uint32).tobytes():
        h0 = ((h0 ^ b) * FNV_PRIME) & 0xFFFFFFFF
        h1 = ((h1 ^ b) * FNV_PRIME) & 0xFFFFFFFF
    return h0.to_bytes(4, "little") + h1.to_bytes(4, "little")
