"""Launch wrapper of the hand-written Hopper ``embedding_bag`` kernel.

The kernel (``csrc/embedding_bag.cu``) replaces the reference's Pallas
kernel ``repro.kernels.embedding_bag.kernel.embedding_bag``.  It is
built by ``kernels._build`` at first use and called through ``ctypes``.
``plan()`` (pure Python) decides how a call is laid out on the card: the
vector width of a row load, the column groups, the rows each warp keeps
in flight, the warps a block and the grid.  This wrapper takes CUDA
tensors only: it checks them, casts the weights to the table's dtype
(as the reference kernel does), allocates the output, launches what the
plan says on the current stream and raises if the launch fails.
``embedding_bag.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .. import _build

__all__ = ["embedding_bag", "plan", "Plan", "launch_args", "Launch"]

DTYPES = {torch.float32: "embedding_bag_f32",
          torch.bfloat16: "embedding_bag_bf16"}
ELT = {torch.float32: 4, torch.bfloat16: 2}
SMS = 132                 # H100 SXM
WIDTHS = (16, 8, 4)       # widths of a row copy, bytes, the widest first
MAX_U = 8                 # rows in flight a warp: more measured slower
RING_BYTES = 48 << 10     # a block's ring of rows in shared memory
MAX_WARPS = 8             # warps a block
BLOCKS_PER_SM = 32        # resident blocks an SM holds at most
WARPS_PER_SM = 64         # resident warps an SM holds at most


class Plan(NamedTuple):
    vec: int              # bytes a lane copies of a row: 16, 8, 4, or 2 (one
                          # bf16 element, for a table 2-byte aligned)
    lanes: int            # lanes of a warp that copy a row's column group
    groups: int           # column groups of a row; a warp per (bag, group)
    rows_in_flight: int   # U: rows a warp keeps in flight ahead of its FMAs
    warps: int            # warps a block
    grid: int             # blocks: ceil(B * groups / warps)
    ring_bytes: int       # a block's ring in shared memory
    bytes_in_flight: int  # row bytes in flight across the card
    bytes_in_flight_sm: int   # and on the busiest SM


def alignment(t: torch.Tensor) -> int:
    """The largest power of two, up to 16, that divides ``t``'s address."""
    ptr = t.data_ptr()
    return min(16, ptr & -ptr) if ptr else 16


@functools.lru_cache(maxsize=1024)
def plan(V: int, d: int, B: int, L: int, dtype: torch.dtype,
         row_align: int) -> Plan:
    """How ``embedding_bag`` sums B bags of L rows of a [V, d] table of
    ``dtype`` whose base is ``row_align``-byte aligned.

    The width is the widest of 16, 8 and 4 bytes that divides the row
    (d x element size) and the alignment; a bf16 table that is only
    2-byte aligned, or whose rows are not a multiple of 4 bytes, copies
    one element a lane.  A row of more than 32 widths takes more column
    groups, its pieces spread evenly over them.  U, the rows a warp
    keeps in flight, is MAX_U or L rounded down to a power of two,
    whichever is less.  A block holds the most warps (1, 2, 4 or 8)
    that leaves four blocks an SM and keeps its ring within
    RING_BYTES."""
    if dtype not in ELT:
        raise TypeError(f"embedding_bag plans float32 or bfloat16 tables, "
                        f"not {dtype}")
    if min(V, d, B) < 1 or L < 0 or row_align < 1:
        raise ValueError(f"embedding_bag needs V, d, B >= 1, L >= 0 and an "
                         f"alignment >= 1, got {(V, d, B, L, row_align)}")
    row = d * ELT[dtype]
    vec = next((w for w in WIDTHS if row % w == 0 and row_align % w == 0),
               ELT[dtype])
    groups = -(-row // (32 * vec))
    lanes = -(-(row // vec) // groups)
    u = min(MAX_U, 1 << (max(L, 1).bit_length() - 1))
    n_warps = B * groups
    slot_ring = u * lanes * vec              # a warp's ring
    warps = MAX_WARPS
    while warps > 1 and (-(-n_warps // warps) < 4 * SMS
                         or warps * slot_ring > RING_BYTES):
        warps //= 2
    grid = -(-n_warps // warps)
    blocks_sm = min(-(-grid // SMS), BLOCKS_PER_SM, WARPS_PER_SM // warps)
    resident = min(n_warps, SMS * blocks_sm * warps)
    group_bytes = row / groups
    return Plan(vec=vec, lanes=lanes, groups=groups, rows_in_flight=u,
                warps=warps, grid=grid, ring_bytes=warps * slot_ring,
                bytes_in_flight=int(resident * u * group_bytes),
                bytes_in_flight_sm=int(blocks_sm * warps * u * group_bytes))


@functools.cache
def _entry(symbol: str):
    fn = getattr(_build.load("embedding_bag"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class Launch(NamedTuple):
    entry: ctypes._CFuncPtr          # the kernel's C entry point
    args: tuple                      # the arguments of its call
    out: torch.Tensor                # what that call writes
    weights: Optional[torch.Tensor]  # the cast weights it reads, kept alive


def launch_args(table: torch.Tensor, ids: torch.Tensor,
                weights: Optional[torch.Tensor] = None, *,
                mean: bool = False) -> Launch:
    """Checks the inputs of ``embedding_bag`` and prepares its call as
    ``plan()`` lays it out.  ``embedding_bag`` is
    ``entry(*args)`` and a check of its error code."""
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
    if mean and weights is not None and weights.dtype != table.dtype:
        raise TypeError(f"embedding_bag's mean takes weights in the table's "
                        f"dtype {table.dtype}, got {weights.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("embedding_bag needs a contiguous table and ids")
    (n_rows, d), (n_bags, bag_len) = table.shape, ids.shape
    if n_rows < 1 or d < 1 or n_bags < 1:
        raise ValueError(f"embedding_bag needs V, d, B >= 1, got table "
                         f"{tuple(table.shape)} and ids {tuple(ids.shape)}")
    if weights is not None:
        weights = weights.to(table.dtype).contiguous()
    p = plan(n_rows, d, n_bags, bag_len, table.dtype, alignment(table))
    out = torch.empty((n_bags, d), dtype=table.dtype, device=table.device)
    args = (table.data_ptr(), ids.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            n_rows, d, n_bags, bag_len, p.vec, p.rows_in_flight, p.groups,
            p.warps, int(mean), table.device.index,
            torch.cuda.current_stream(table.device).cuda_stream)
    return Launch(_entry(DTYPES[table.dtype]), args, out, weights)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, *,
                  mean: bool = False) -> torch.Tensor:
    """table [V, d] float32 or bfloat16, ids [B, L] int32 and weights
    [B, L] (any float dtype; None = all ones) on one CUDA device,
    contiguous, V, d, B >= 1 -> [B, d] in the table's dtype: per bag
    the weighted sum of its rows (ids clipped to [0, V-1]), accumulated
    in fp32.  ``mean``: that sum over the bag's weight sum (or L),
    divided in the kernel as the reference's op divides; it takes
    weights in the table's dtype or None."""
    call = launch_args(table, ids, weights, mean=mean)
    err = call.entry(*call.args)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed with CUDA error "
                           f"{err}")
    _build.count_launches(embedding_bag, 1)
    return call.out


embedding_bag.launches = 0
