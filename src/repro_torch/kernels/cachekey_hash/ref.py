"""Plain PyTorch version of ``cachekey_hash``: the semantics.

Dual-lane 32-bit FNV-1a over int32 token rows.  Lane 0 uses the standard
FNV offset and prime; lane 1 an independent offset (digits of pi) with
the same prime.  Each token is reinterpreted as uint32 and mixed as its
4 bytes, lowest first (little-endian).

Torch's ``uint32`` supports few operations, so the lanes live in
``int64`` and are masked to 32 bits after every multiply: a lane is
below 2^32 and the prime below 2^25, so no product reaches 2^57 and
nothing overflows before the mask.  The two lanes fold as one [N, 2]
tensor.
"""
from __future__ import annotations

import torch

__all__ = ["FNV_OFFSET", "FNV_PRIME", "LANE2_OFFSET", "cachekey_hash_ref",
           "as_int32_bits"]

FNV_OFFSET = 0x811C9DC5
FNV_PRIME = 0x01000193
LANE2_OFFSET = 0x31415927
_MASK = 0xFFFFFFFF


def as_int32_bits(h: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor holding the same bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def cachekey_hash_ref(tokens: torch.Tensor) -> torch.Tensor:
    """tokens [N, L] int32 -> [N, 2] int32 holding the two uint32 lanes'
    bits (``out.to(torch.int64) & 0xFFFFFFFF`` gives the lanes)."""
    t = tokens.to(torch.int64) & _MASK                    # as uint32
    n, L = t.shape
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64,
                          device=t.device)
    # [N, 4L] bytes in mixing order: token 0's low byte first
    data = ((t[:, :, None] >> shifts) & 0xFF).reshape(n, 4 * L)
    h = torch.tensor([FNV_OFFSET, LANE2_OFFSET], dtype=torch.int64,
                     device=t.device).repeat(n, 1)
    for j in range(4 * L):
        h = ((h ^ data[:, j:j + 1]) * FNV_PRIME) & _MASK
    return as_int32_bits(h)
