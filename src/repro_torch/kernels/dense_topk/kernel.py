"""Launch wrapper of the hand-written Hopper ``dense_topk`` kernel.

The kernel (``csrc/dense_topk.cu``) replaces the reference's Pallas
kernel ``repro.kernels.dense_topk.kernel.dense_topk``.  It is built by
``kernels._build`` at first use and called through ``ctypes``.  This
wrapper takes CUDA tensors only: it checks them, allocates the outputs
and the scratch, launches on the current stream and raises if a launch
fails.  ``plan`` picks the path and decides how the work is spread over
the card's SMs: ``"filter"`` for k <= FILTER_K (per-split threshold
filter in shared memory, then a merge launch when the corpus is split),
``"select"`` above it (a score buffer in device memory, query chunk by
query chunk, and an exact radix select).  ``dense_topk.launches`` counts
CUDA launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .. import _build

__all__ = ["dense_topk", "plan", "Plan", "FILTER_K", "SELECT_CAP"]

FILTER_K = 1024        # the most the filter path's rows hold: k_pad + CAND slots
MAX_SMEM = 232448      # bytes of shared memory a block may use on sm_90
SMS = 132              # streaming multiprocessors of an H100 SXM
BQ = 16                # queries per block (kBQ in the source)
BN = 128               # docs per tile (kBN)
BK = 32                # dims per chunk (kBK)
CAND = 256             # candidate slots per query row (kCand)
STAGE_BYTES = (BN + BQ) * BK * 4 + 16   # fp32: TMA boxes and 2 barriers
MAX_STAGES = 4         # depth of the fp32 TMA ring, where it fits
SELECT_CAP = 1 << 30   # bytes of scratch a query chunk of the select path holds
SLICE = 8192           # docs a radix-select block walks (kSlice)
SORT_CHUNK = 8192      # winner slots a sort block holds (kSortChunk)
MAX_CHUNK = 65535      # query rows of a chunk: the grid's y limit
DTYPES = {torch.float32: "dense_topk_select_f32",
          torch.bfloat16: "dense_topk_select_bf16"}
LARGE = {torch.float32: "dense_topk_large_f32",
         torch.bfloat16: "dense_topk_large_bf16"}


class Plan(NamedTuple):
    bq: int              # queries per block
    splits: int          # corpus splits S: the grid is (ceil(Q / bq), S)
    per_split: int       # docs per split, a multiple of BN; the last is short
    k_pad: int           # power of two >= k: the sort's length
    stages: int          # depth of the fp32 TMA ring (bf16: 2 stages)
    launches: int        # CUDA launches of the whole call
    smem: int            # shared memory bytes of the stage-1 block
    merge_smem: int      # of the merge block (0 without one)
    path: str = "filter"  # "filter" (k <= FILTER_K) or "select"
    q_chunk: int = 0     # select: query rows a chunk scores at once
    slices: int = 0      # select: blocks a row's radix select takes
    work_bytes: int = 0  # select: device scratch of one chunk


def merge_smem(splits: int, k: int, k_pad: int) -> int:
    """Shared memory of the merge block: value, index and key of each of
    the splits' k candidates, the k_pad winners, 9 reduction slots."""
    return 12 * splits * k + 8 * k_pad + 4 * 9


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sort_launches(k_pad: int) -> int:
    """Launches of the select path's bitonic sort of k_pad slots: one
    that sorts each chunk in shared memory, then for every longer merge
    one launch per stride >= the chunk and one for the shorter ones."""
    chunk = min(k_pad, SORT_CHUNK)
    n, size = 1, 2 * chunk
    while size <= k_pad:
        n += (size // chunk).bit_length()    # log2(size / chunk) + 1
        size *= 2
    return n


@functools.lru_cache(maxsize=1024)
def plan(Q: int, N: int, d: int, k: int, sms: int = SMS) -> Plan:
    """How ``dense_topk`` computes a [Q, d] x [N, d] top-k on the card.

    ``"filter"`` (k_pad <= FILTER_K): as many splits as ceil(Q / BQ) x S
    blocks fit on ``sms`` SMs, but each split keeps at least 4 x k_pad
    docs (so the threshold filter has docs to drop) and the merge's
    S x k candidates fit one block's shared memory.

    ``"select"`` (larger k): the queries go in chunks whose scores
    [q_chunk, N] f32, radix counts and k_pad winner slots fit SELECT_CAP
    bytes (at least one query a chunk); each chunk's scores are spread
    over the SMs as above, without the filter's limits.

    Shared memory does not depend on d: it is walked in chunks of BK."""
    if not (Q >= 1 and N >= 1 and d >= 1 and 1 <= k <= N):
        raise ValueError(f"dense_topk plan needs Q, N, d >= 1 and "
                         f"1 <= k <= N, got Q={Q} N={N} d={d} k={k}")
    k_pad = 1 << (k - 1).bit_length()
    if k_pad > FILTER_K:
        slices = _cdiv(N, SLICE)
        per_query = 4 * N + 4 * 1024 + 8 * slices + 8 * k_pad
        chunk = max(1, min(Q, MAX_CHUNK, SELECT_CAP // per_query))
        per = BN * _cdiv(_cdiv(N, max(1, sms // _cdiv(chunk, BQ))), BN)
        return Plan(bq=BQ, splits=_cdiv(N, per), per_split=per, k_pad=k_pad,
                    stages=MAX_STAGES,
                    launches=_cdiv(Q, chunk) * (7 + sort_launches(k_pad)),
                    smem=1024 + MAX_STAGES * STAGE_BYTES, merge_smem=0,
                    path="select", q_chunk=chunk, slices=slices,
                    work_bytes=chunk * per_query)
    most = min(sms // _cdiv(Q, BQ), N // max(BN, 4 * k_pad),
               (MAX_SMEM - merge_smem(0, k, k_pad)) // (12 * k))
    per = BN * _cdiv(_cdiv(N, max(1, most)), BN)
    splits = _cdiv(N, per)
    lists = BQ * (k_pad + CAND) * 8
    stages = min(MAX_STAGES, (MAX_SMEM - 1024 - lists) // STAGE_BYTES)
    return Plan(bq=BQ, splits=splits, per_split=per, k_pad=k_pad,
                stages=stages, launches=1 if splits == 1 else 2,
                smem=1024 + stages * STAGE_BYTES + lists,
                merge_smem=merge_smem(splits, k, k_pad) if splits > 1 else 0)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# (q, c, out_v, out_i, n_q, n_docs, d, k, k_pad, splits, per_split,
#  stages, device, stream)
_SELECT_ARGS = [_PTR] * 4 + [_INT] * 9 + [_PTR]
# (part_v, part_i, vals, idxs, n_q, splits, k, k_pad, device, stream)
_MERGE_ARGS = [_PTR] * 4 + [_INT] * 5 + [_PTR]
# (q, c, work, vals, idxs, n_q, n_docs, d, k, k_pad, splits, per_split,
#  stages, slices, device, stream)
_LARGE_ARGS = [_PTR] * 5 + [_INT] * 10 + [_PTR]


@functools.cache
def _entry(symbol: str):
    fn = getattr(_build.load("dense_topk"), symbol)
    fn.argtypes = (_MERGE_ARGS if symbol == "dense_topk_merge" else
                   _LARGE_ARGS if symbol in LARGE.values() else _SELECT_ARGS)
    fn.restype = ctypes.c_int
    return fn


def _check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"dense_topk launch failed with CUDA error {err}")


def dense_topk(q: torch.Tensor, c: torch.Tensor, *, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [Q, d], c [N, d] on one CUDA device, both float32 or both
    bfloat16 (upcast to fp32 in the kernel), contiguous; 1 <= k <= N.
    Returns ``(vals [Q, k] f32, idxs [Q, k] i32)``, ordered by
    descending score, then ascending doc index."""
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
    if not 1 <= k <= n_docs:
        raise ValueError(f"dense_topk takes 1 <= k <= N, got k={k} with "
                         f"N={n_docs}")
    p = plan(n_q, n_docs, d, k, sms=_sms(q.device.index))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if p.path == "select":
        return _select(q, c, k, p, stream)
    # with splits, vals and idxs are allocated while stage 1 runs
    if p.splits == 1:
        vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
        idxs = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
        out = (vals.data_ptr(), idxs.data_ptr())
    else:
        part = torch.empty(2 * n_q * p.splits * k, dtype=torch.int32,
                           device=q.device)
        out = (part.data_ptr(), part.data_ptr() + 2 * part.numel())
    _check(_entry(DTYPES[q.dtype])(
        q.data_ptr(), c.data_ptr(), *out, n_q, n_docs, d, k, p.k_pad,
        p.splits, p.per_split, p.stages, q.device.index, stream))
    if p.splits > 1:
        vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
        idxs = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
        _check(_entry("dense_topk_merge")(
            *out, vals.data_ptr(), idxs.data_ptr(), n_q, p.splits, k,
            p.k_pad, q.device.index, stream))
    _build.count_launches(dense_topk, p.launches)
    return vals, idxs


def _select(q: torch.Tensor, c: torch.Tensor, k: int, p: Plan,
            stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The select path, one query chunk after another through one
    scratch buffer."""
    (n_q, d), n_docs, dev = q.shape, c.shape[0], q.device
    vals = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    work = torch.empty(p.work_bytes // 4, dtype=torch.int32, device=dev)
    row = d * q.element_size()
    for c0 in range(0, n_q, p.q_chunk):
        _check(_entry(LARGE[q.dtype])(
            q.data_ptr() + c0 * row, c.data_ptr(), work.data_ptr(),
            vals.data_ptr() + c0 * k * 4, idxs.data_ptr() + c0 * k * 4,
            min(p.q_chunk, n_q - c0), n_docs, d, k, p.k_pad, p.splits,
            p.per_split, p.stages, p.slices, dev.index, stream))
    _build.count_launches(dense_topk, p.launches)
    return vals, idxs


dense_topk.launches = 0
