"""Launch wrapper of the hand-written Hopper ``flash_attention`` kernels.

The kernels (``csrc/flash_attention.cu`` and the headers it includes)
replace the reference's Pallas kernel
``repro.kernels.flash_attention.kernel.flash_attention`` (forward).
They are built by ``kernels._build`` at first use and called through
``ctypes``.  ``path_for``, a pure function of the shapes, picks one of
three paths, and nothing else does:

* ``"wgmma"`` — bf16, hd 64 or 128, more than 16 query rows per KV
  head (G·Sq > 16): prefill.  Bound by operations, so on the tensor
  cores: K/V tiles come through TMA into a ring of shared memory, a
  producer warp keeps it full, two consumer warpgroups each run S = QKᵀ
  and O += PV with ``wgmma``.  P enters the PV product in bf16 (as the
  reference's oracle rounds it), so this path is held to
  ``ref.bf16p_excess``.
* ``"decode"`` — any dtype, at most 16 query rows per KV head, hd·(bytes
  of the dtype) a power-of-two multiple of 16 bytes up to 512: a decode
  step or a short chunk against a long cache.  Bound by bytes: the key
  axis is split across blocks (``decode_splits``), warps stream keys
  with 16-byte loads with the next chunk in flight, and a second small
  kernel merges the splits' partial (m, l, acc).  P stays fp32.
* ``"simt"`` — everything else (f32 prefill, bf16 at other head
  sizes): scalar fp32 on shared-memory tiles, the first kernel of the
  port.  f32 stays off the tensor cores: TF32 is opt-in in this repo.

Every path takes the reference kernel's ``sk_valid`` (keys at or past
it are masked; its loops and ``decode_splits`` stop there, so no block
is spent on them) and ``q_offset`` (the causal offset); a key row's
stride stays the tensor's Sk, so a decode step reads a preallocated
cache in place.

This wrapper takes CUDA tensors only: it checks them, allocates the
output and scratch, launches on the current stream and raises if a
launch fails; nothing falls back to another path.
``flash_attention.launches`` counts kernel launches (a split decode
counts 2) and ``flash_attention.paths`` counts calls by path.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
import torch

from .. import _build
from .ref import offsets

__all__ = ["flash_attention", "path_for", "decode_splits", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128     # a lane owns at most 4 of a row's output columns
DECODE_MAX_ROWS = 16   # query rows per KV head (G·Sq) a decode block holds
SMS = 132              # an H100 SXM's streaming multiprocessors
DECODE_BLOCKS = 32 * SMS   # enough blocks that the last wave is short
DECODE_MIN_KEYS = 256      # keys per split, at least
_ELT = {torch.float32: 4, torch.bfloat16: 2}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def path_for(dtype: torch.dtype, B: int, H: int, K: int, Sq: int, Sk: int,
             hd: int, causal: bool) -> str:
    """The kernel that runs attention at these shapes: ``"wgmma"``,
    ``"decode"`` or ``"simt"`` (see the module's docstring).  ``causal``
    does not change the path; it is taken so that the choice is a
    function of the whole call."""
    del B, causal
    rows = (H // K) * Sq
    lanes = hd * _ELT[dtype] // 16   # lanes that hold one key row
    if Sk >= 1 and rows <= DECODE_MAX_ROWS and hd * _ELT[dtype] % 16 == 0 \
            and lanes & (lanes - 1) == 0 and lanes <= 32:
        return "decode"
    if Sk >= 1 and dtype == torch.bfloat16 and hd in (64, 128):
        return "wgmma"
    return "simt"


def decode_splits(B: int, K: int, Sk: int) -> tuple[int, int]:
    """(splits of the key axis, keys per split) of the ``"decode"`` path:
    about DECODE_BLOCKS blocks of (batch, KV head, split) in all, at
    least DECODE_MIN_KEYS keys a split, a multiple of 64."""
    n = max(1, min(_cdiv(DECODE_BLOCKS, B * K), _cdiv(Sk, DECODE_MIN_KEYS)))
    per = 64 * _cdiv(_cdiv(Sk, n), 64)
    return _cdiv(Sk, per), per


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# (q, k, v, out, B, H, K, Sq, Sk, sk_valid, q_offset, hd, scale, causal,
#  device, stream)
_ARGS = [_PTR] * 4 + [_INT] * 8 + [ctypes.c_float, _INT, _INT, _PTR]
# (q, k, v, out, part_ml, part_acc, B, H, K, Sq, Sk, sk_valid, q_offset,
#  hd, scale, causal, n_splits, per, device, stream)
_DECODE_ARGS = [_PTR] * 6 + [_INT] * 8 + [ctypes.c_float] + [_INT] * 4 \
    + [_PTR]


@functools.cache
def _entry(symbol: str):
    fn = getattr(_build.load("flash_attention"), symbol)
    fn.argtypes = _DECODE_ARGS if "_decode_" in symbol else _ARGS
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """TMA reads from a 16-byte aligned base: a view that is not is
    copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sk_valid: int | None = None,
                    q_offset: int | None = None) -> torch.Tensor:
    """q [B, H, Sq, hd], k and v [B, K, Sk, hd] on one CUDA device, all
    float32 or all bfloat16, contiguous; H a multiple of K; 1 <= hd <=
    128.  Keys at or past ``sk_valid`` (default Sk) are masked; if
    ``causal``, so is key j for query row i when j > i + ``q_offset``
    (default sk_valid - Sq).  Scores are scaled by 1/sqrt(hd).  Returns
    [B, H, Sq, hd] in q's dtype."""
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"flash_attention needs q, k and v on one CUDA "
                         f"device, got {q.device}, {k.device} and "
                         f"{v.device}")
    if q.dtype not in _ELT or k.dtype != q.dtype or v.dtype != q.dtype:
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
    sk_valid, q_offset = offsets(Sq, Sk, sk_valid, q_offset)
    if abs(q_offset) >= 1 << 30:
        raise ValueError(f"flash_attention takes |q_offset| < 2**30, got "
                         f"{q_offset}")
    path = path_for(q.dtype, B, H, K, Sq, sk_valid, hd, causal)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_launches = 1
    if path == "wgmma":
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        err = _entry("flash_attention_wgmma_bf16")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, K, Sq, Sk, sk_valid, q_offset, hd, scale, int(causal),
            q.device.index, stream)
    elif path == "decode":
        n_splits, per = decode_splits(B, K, sk_valid)
        rows = (H // K) * Sq
        part_ml = part_acc = None
        if n_splits > 1:
            part_ml = torch.empty(B, K, n_splits, rows, 2, device=q.device)
            part_acc = torch.empty(B, K, n_splits, rows, hd, device=q.device)
            n_launches = 2
        err = _entry(f"flash_attention_decode_{_SUFFIX[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            B, H, K, Sq, Sk, sk_valid, q_offset, hd, scale, int(causal),
            n_splits, per, q.device.index, stream)
    else:
        err = _entry(f"flash_attention_{_SUFFIX[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, K, Sq, Sk, sk_valid, q_offset, hd, scale, int(causal),
            q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({path} path) launch failed "
                           f"with CUDA error {err}")
    _build.count_launches(flash_attention, n_launches)
    flash_attention.paths[path] += 1
    return out


flash_attention.launches = 0
flash_attention.paths = collections.Counter()
