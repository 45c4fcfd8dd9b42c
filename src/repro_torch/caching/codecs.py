"""Vectorized cache serialization: batch key digests and columnar
value codecs, negotiated per directory through the manifest.

Counterpart of ``repro.caching.codecs``, byte-identical to it: keys,
KV values and columnar frames written by either package decode in the
other.  The key digests are host numpy here as in the reference.

Why a second key scheme exists at all: the original ``_keys_of`` walks
every row through ``zip(*cols)`` + ``pickle.dumps`` — a Python-level
loop that shows up at the top of warm-path profiles once the store
round trip itself is prefetched off the critical path.  The scheme
here builds all keys for a frame with a handful of numpy passes:

* **``fnv128`` keys** — per key column, a four-lane FNV-1a digest
  (the same per-byte fold as the ``cachekey_hash`` kernel and
  ``provenance._host_digest``, widened from two lanes to four so a
  column contributes 128 bits) folded *vectorized across rows*: the
  column is laid out as an ``(N, W)`` byte matrix and the fold runs
  once per byte *position*, masked by per-row lengths — so a row's
  digest depends only on its own bytes, never on what else shares the
  batch.  A key is the concatenation of its columns' 16-byte digests.

* **tagged KV values** — an all-``float`` value tuple packs as a raw
  little-endian float64 vector behind a one-byte tag; anything else
  keeps the pickle representation behind a different tag.  A warm
  batch whose blobs are all packed decodes into value *columns* with
  one ``frombuffer``/``reshape`` instead of N ``pickle.loads``.

* **columnar retriever entries** — a cached result frame is stored as
  named column arrays (raw numeric bytes, length-prefixed UTF-8 for
  strings, pickle only for exotic dtypes), zlib-1 compressed, and
  decodes straight into ``ColFrame`` columns — no per-row dict round
  trip.  Scores keep their stored dtype (float64 end to end), so a
  decoded frame is bit-identical to the frame that was encoded.

Negotiation: the directory's manifest records ``codec`` when a store
is *created*; directories that predate the field (or were written by
older builds) have none and are served with the legacy pickle scheme
forever — an existing warm dir stays warm, byte for byte.

Determinism caveat (documented contract): ``fnv128`` encodes numeric
key columns from their array bytes, so a logical value that arrives as
``int64`` in one frame and as a Python object in another digests
differently — a spurious *miss* (recompute, identical result), never a
false hit.  ``ColFrame`` column construction is deterministic per
source type, so in practice a family sees one layout for its lifetime.
"""
from __future__ import annotations

import pickle
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .provenance import _FNV_OFFSET, _FNV_PRIME, _LANE2_OFFSET, \
    canonical_bytes

__all__ = [
    "KV_CODEC", "RETRIEVER_CODEC", "KNOWN_CODECS",
    "vector_keys", "scalar_key",
    "encode_kv_value", "decode_kv_value", "decode_kv_batch",
    "encode_columnar_frame", "decode_columnar_frame",
]

#: manifest ``codec`` values understood by this build
KV_CODEC = "kv-fnv128-pack1"
RETRIEVER_CODEC = "ret-fnv128-col1"
KNOWN_CODECS = frozenset({KV_CODEC, RETRIEVER_CODEC})

# four FNV-1a lanes: the provenance/kernel pair plus two more offsets
# (golden-ratio and murmur3 constants) so one column yields 128 bits
_LANES = np.array([_FNV_OFFSET, _LANE2_OFFSET, 0x9E3779B9, 0x85EBCA6B],
                  dtype=np.uint64)
_PRIME = np.uint64(_FNV_PRIME)
_MASK32 = np.uint64(0xFFFFFFFF)

#: per-column byte-matrix width beyond which the vector fold would cost
#: more than it saves — such columns fall back to the scalar fold
_MAX_VECTOR_WIDTH = 4096


# -- the fold ----------------------------------------------------------------

def _fold_const(lanes: np.ndarray, byte: int) -> np.ndarray:
    """Fold one constant byte into every row's lanes."""
    return ((lanes ^ np.uint64(byte)) * _PRIME) & _MASK32


def _fold_matrix(lanes: np.ndarray, mat: np.ndarray,
                 lens: np.ndarray) -> np.ndarray:
    """Fold an ``(N, W)`` byte matrix into ``(N, 4)`` lanes, row ``i``
    consuming only its first ``lens[i]`` bytes — each row's digest
    depends only on its own bytes, so results are independent of batch
    composition."""
    width = mat.shape[1]
    if width == 0:
        return lanes
    if bool((lens == width).all()):
        m64 = mat.astype(np.uint64)
        out = np.array(lanes, dtype=np.uint64)
        for j in range(width):
            # in-place fold: no temporaries on the hot path
            np.bitwise_xor(out, m64[:, j:j + 1], out=out)
            np.multiply(out, _PRIME, out=out)
            np.bitwise_and(out, _MASK32, out=out)
        return out
    # ragged rows: sort by length descending so the rows still active
    # at byte position j are a contiguous prefix — folds run on views,
    # no per-position mask
    order = np.argsort(-lens, kind="stable")
    m64 = mat[order].astype(np.uint64)
    sorted_lens = lens[order]
    # counts[j] = rows with length > j (prefix size at position j)
    counts = len(lens) - np.searchsorted(sorted_lens[::-1],
                                         np.arange(width), side="right")
    out = np.array(lanes[order], dtype=np.uint64)
    for j in range(width):
        k = int(counts[j])
        if k == 0:
            break
        seg = out[:k]
        np.bitwise_xor(seg, m64[:k, j:j + 1], out=seg)
        np.multiply(seg, _PRIME, out=seg)
        np.bitwise_and(seg, _MASK32, out=seg)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return out[inv]


def _scalar_fold(lanes: List[int], data: bytes) -> List[int]:
    out = list(lanes)
    for b in data:
        out = [((h ^ b) * _FNV_PRIME) & 0xFFFFFFFF for h in out]
    return out


# -- per-column byte layout ---------------------------------------------------

def _object_payloads(col: Sequence[Any]) -> List[bytes]:
    """Type-marked bytes for each value of an object column: strings
    take the fast UTF-8 path, everything else the canonical encoding."""
    out: List[bytes] = []
    for v in col:
        if isinstance(v, str):
            out.append(b"s" + v.encode("utf-8"))
        else:
            out.append(b"c" + canonical_bytes(v))
    return out


def _string_matrix(col: List[Any]
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Padded payload matrix for an all-``str`` column via numpy's
    fixed-width encode — no per-row Python encode loop.  ``None`` when
    the column is mixed-type or a string contains NUL (fixed-width
    ``S`` storage strips trailing NULs, which would change the digest
    vs :func:`scalar_key` — such columns take the general path)."""
    if not all(type(v) is str for v in col):
        return None
    ucol = np.asarray(col, dtype="U")
    if ucol.size and int(np.char.find(ucol, "\x00").max()) >= 0:
        return None
    enc = np.char.encode(ucol, "utf-8")
    n, width = len(col), enc.dtype.itemsize
    raw = np.frombuffer(enc.tobytes(), dtype=np.uint8).reshape(n, width) \
        if width else np.zeros((n, 0), dtype=np.uint8)
    # payload = b"s" + utf8 bytes: prepend the tag column
    mat = np.empty((n, width + 1), dtype=np.uint8)
    mat[:, 0] = ord("s")
    mat[:, 1:] = raw
    lens = np.char.str_len(enc).astype(np.int64) + 1
    return mat, lens


def _payload_matrix(payloads: List[bytes]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variable-length payloads into an ``(N, W)`` uint8 matrix
    plus a length vector, via one join + one fancy-index gather."""
    n = len(payloads)
    lens = np.fromiter((len(p) for p in payloads), dtype=np.int64, count=n)
    width = int(lens.max()) if n else 0
    if width == 0:
        return np.zeros((n, 0), dtype=np.uint8), lens
    arr = np.frombuffer(b"".join(payloads), dtype=np.uint8)
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    idx = offs[:, None] + np.arange(width, dtype=np.int64)[None, :]
    np.minimum(idx, max(len(arr) - 1, 0), out=idx)
    return arr[idx], lens


def _column_lanes(col: np.ndarray) -> np.ndarray:
    """``(N, 4)`` uint64 lanes digesting one key column."""
    n = len(col)
    lanes = np.broadcast_to(_LANES, (n, 4)).astype(np.uint64)
    kind = col.dtype.kind
    if kind in "iu":
        mat = np.ascontiguousarray(
            col.astype("<i8")).view(np.uint8).reshape(n, 8)
        lens = np.full(n, 8, dtype=np.int64)
        lanes = _fold_const(lanes, ord("q"))
    elif kind == "f":
        mat = np.ascontiguousarray(
            col.astype("<f8")).view(np.uint8).reshape(n, 8)
        lens = np.full(n, 8, dtype=np.int64)
        lanes = _fold_const(lanes, ord("d"))
    else:
        lanes = _fold_const(lanes, ord("o"))
        col_list = col.tolist()
        packed = _string_matrix(col_list)
        if packed is not None:
            mat, lens = packed
        else:
            payloads = _object_payloads(col_list)
            mat, lens = _payload_matrix(payloads)
            if mat.shape[1] > _MAX_VECTOR_WIDTH:
                return np.array(
                    [_scalar_column_lanes_obj(p) for p in payloads],
                    dtype=np.uint64)
        if mat.shape[1] > _MAX_VECTOR_WIDTH:
            return np.array(
                [_scalar_column_lanes_obj(b"s" + v.encode("utf-8"))
                 for v in col_list], dtype=np.uint64)
    # 4-byte little-endian length prefix, then the payload bytes
    len_bytes = np.ascontiguousarray(
        lens.astype("<u4")).view(np.uint8).reshape(n, 4)
    lanes = _fold_matrix(lanes, len_bytes, np.full(n, 4, dtype=np.int64))
    return _fold_matrix(lanes, mat, lens)


def _scalar_column_lanes_obj(payload: bytes) -> List[int]:
    lanes = _scalar_fold([int(x) for x in _LANES], b"o")
    lanes = _scalar_fold(lanes, struct.pack("<I", len(payload)))
    return _scalar_fold(lanes, payload)


def vector_keys(cols: Sequence[np.ndarray]) -> List[bytes]:
    """One 16·ncols-byte key per row, built with numpy passes over the
    key columns.  Bit-compatible with :func:`scalar_key`."""
    if not cols or len(cols[0]) == 0:
        return []
    n = len(cols[0])
    lanes = np.concatenate([_column_lanes(np.asarray(c)) for c in cols],
                           axis=1)                       # (N, 4·C)
    packed = np.ascontiguousarray(lanes.astype("<u4")) \
        .view(np.uint8).reshape(n, -1)                   # (N, 16·C)
    return [row.tobytes() for row in packed]


def scalar_key(values: Sequence[Any], kinds: Sequence[str]) -> bytes:
    """Single-row reference implementation of :func:`vector_keys` —
    property-tested to match it bit for bit.  ``kinds`` are the key
    columns' dtype kinds (``col.dtype.kind``)."""
    out = bytearray()
    for v, kind in zip(values, kinds):
        if kind in "iu":
            tag, payload = ord("q"), struct.pack("<q", int(v))
        elif kind == "f":
            tag, payload = ord("d"), struct.pack("<d", float(v))
        elif isinstance(v, str):
            tag, payload = ord("o"), b"s" + v.encode("utf-8")
        else:
            tag, payload = ord("o"), b"c" + canonical_bytes(v)
        lanes = _scalar_fold([int(x) for x in _LANES], bytes([tag]))
        lanes = _scalar_fold(lanes, struct.pack("<I", len(payload)))
        lanes = _scalar_fold(lanes, payload)
        out += b"".join(struct.pack("<I", h) for h in lanes)
    return bytes(out)


# -- tagged KV value codec ----------------------------------------------------

_TAG_PICKLE = 0x01
_TAG_F64 = 0x02


def encode_kv_value(vals: Tuple) -> bytes:
    """Pack an all-float value tuple raw; keep pickle for the rest."""
    if vals and all(isinstance(v, (float, np.floating)) for v in vals):
        return bytes([_TAG_F64]) + \
            np.asarray(vals, dtype="<f8").tobytes()
    return bytes([_TAG_PICKLE]) + \
        pickle.dumps(vals, protocol=pickle.HIGHEST_PROTOCOL)


def decode_kv_value(blob: bytes) -> Tuple:
    tag = blob[0]
    if tag == _TAG_F64:
        return tuple(np.frombuffer(blob, dtype="<f8", offset=1).tolist())
    if tag == _TAG_PICKLE:
        return pickle.loads(blob[1:])
    raise ValueError(f"unknown KV value tag {tag:#x}")


def decode_kv_batch(blobs: Sequence[bytes],
                    n_cols: int) -> Optional[np.ndarray]:
    """Vectorized decode of a warm batch: if *every* blob is a packed
    float vector of ``n_cols`` values, return an ``(N, n_cols)``
    float64 array in one pass; otherwise ``None`` (decode row-wise)."""
    want = 1 + 8 * n_cols
    if not blobs or any(
            b is None or b[0] != _TAG_F64 or len(b) != want for b in blobs):
        return None
    joined = b"".join(bytes(memoryview(b)[1:]) for b in blobs)
    return np.frombuffer(joined, dtype="<f8").reshape(len(blobs), n_cols)


# -- columnar retriever entry codec ------------------------------------------

_COL_MAGIC = b"RCOL1"
_KIND_F64 = ord("f")
_KIND_I64 = ord("i")
_KIND_STR = ord("s")
_KIND_PKL = ord("p")


def encode_columnar_frame(cols: Sequence[Tuple[str, np.ndarray]],
                          n_rows: int) -> bytes:
    """Encode named columns as raw arrays (zlib-1 over the whole blob).
    Numeric dtypes keep their width — a float64 score round-trips bit
    identical; strings store a length array plus joined UTF-8."""
    parts: List[bytes] = [
        _COL_MAGIC, struct.pack("<IH", n_rows, len(cols))]
    for name, arr in cols:
        nb = name.encode("utf-8")
        kind = arr.dtype.kind
        if kind == "f":
            tag, payload = _KIND_F64, \
                np.ascontiguousarray(arr.astype("<f8")).tobytes()
        elif kind in "iu":
            tag, payload = _KIND_I64, \
                np.ascontiguousarray(arr.astype("<i8")).tobytes()
        else:
            vals = arr.tolist()
            if all(isinstance(v, str) for v in vals):
                encoded = [v.encode("utf-8") for v in vals]
                lens = np.fromiter((len(e) for e in encoded),
                                   dtype="<u4", count=len(encoded))
                tag, payload = _KIND_STR, lens.tobytes() + b"".join(encoded)
            else:
                tag, payload = _KIND_PKL, pickle.dumps(
                    vals, protocol=pickle.HIGHEST_PROTOCOL)
        parts.append(struct.pack("<HBI", len(nb), tag, len(payload)))
        parts.append(nb)
        parts.append(payload)
    return zlib.compress(b"".join(parts), 1)


def decode_columnar_frame(blob: bytes) -> Dict[str, np.ndarray]:
    """Decode straight to column arrays (strings as object dtype, the
    layout ``ColFrame`` itself uses) — no per-row dict materialization."""
    raw = zlib.decompress(blob)
    if raw[:len(_COL_MAGIC)] != _COL_MAGIC:
        raise ValueError("bad columnar frame magic")
    off = len(_COL_MAGIC)
    n_rows, n_cols = struct.unpack_from("<IH", raw, off)
    off += struct.calcsize("<IH")
    out: Dict[str, np.ndarray] = {}
    for _ in range(n_cols):
        nlen, tag, plen = struct.unpack_from("<HBI", raw, off)
        off += struct.calcsize("<HBI")
        name = raw[off:off + nlen].decode("utf-8")
        off += nlen
        payload = raw[off:off + plen]
        off += plen
        if tag == _KIND_F64:
            out[name] = np.frombuffer(payload, dtype="<f8").astype(np.float64)
        elif tag == _KIND_I64:
            out[name] = np.frombuffer(payload, dtype="<i8").astype(np.int64)
        elif tag == _KIND_STR:
            lens = np.frombuffer(payload, dtype="<u4", count=n_rows)
            col = np.empty(n_rows, dtype=object)
            p = 4 * n_rows
            for i, ln in enumerate(lens.tolist()):
                col[i] = payload[p:p + ln].decode("utf-8")
                p += ln
            out[name] = col
        elif tag == _KIND_PKL:
            col = np.empty(n_rows, dtype=object)
            vals = pickle.loads(payload)
            for i, v in enumerate(vals):
                col[i] = v
            out[name] = col
        else:
            raise ValueError(f"unknown column tag {tag:#x}")
    return out
