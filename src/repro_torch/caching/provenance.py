"""Provenance layer: fingerprints, cache manifests, staleness policies.

Counterpart of ``repro.caching.provenance``; digests, encodings and
manifests are byte-identical to the reference's.  The source paper warns that cached result files are "brittle and can
cause a disconnect between the conceptual design of the pipeline and
its logical implementation" — a cache directory keyed only on *input
values* silently serves stale results after a transformer's parameters,
corpus or code change.  This module closes that gap:

* **Fingerprints** — every transformer has a stable provenance
  fingerprint: class identity (module + qualname + a hash of the class
  source when obtainable) plus its structural ``signature()`` plus any
  declared ``fingerprint_extras()`` (corpus versions, checkpoint ids),
  hashed with the dual-lane FNV-1a digest of the ``cachekey_hash``
  kernel (``kernels/cachekey_hash``) on the card, or with the kernel's
  plain version on the CPU when the caller asked for it
  (:func:`set_digest_device`).  There is no fallback between the two.
  The execution
  planner extends this to *node* fingerprints by folding in the
  fingerprints of all upstream nodes, so invalidation propagates
  downstream exactly as results do.

* **Manifests** — every cache directory carries a versioned
  ``manifest.json`` recording the fingerprint, cache family, storage
  backend, schema (key/value columns), creation / last-use timestamps
  and entry counts, protected by a content checksum.  A cache dir is
  thereby self-describing: it can be listed, verified, garbage
  collected and shared (the reference's ``repro cache`` CLI reads
  the same files).

* **Staleness policies** — opening a cache whose manifest disagrees
  with the caller's provenance raises :class:`StaleCacheError` by
  default; ``on_stale="recompute"`` discards the stale entries and
  recomputes, ``on_stale="readonly"`` serves the existing entries but
  refuses to write (useful when the mismatch is known-cosmetic).

This module imports nothing from ``repro_torch.core`` (it works on
duck-typed transformers).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .backends import atomic_write_bytes

__all__ = [
    "MANIFEST_NAME", "MANIFEST_VERSION", "PLAN_MANIFEST_VERSION",
    "PLANS_SUBDIR", "ProvenanceError", "ManifestError", "StaleCacheError",
    "canonical_bytes", "digest_bytes", "class_source_hash",
    "transformer_fingerprint", "combine_fingerprints", "CacheManifest",
    "manifest_path", "plan_manifest_dir", "save_plan_manifest",
    "iter_plan_manifests", "set_digest_device",
]

MANIFEST_NAME = "manifest.json"
#: v2 adds the optional cache-economics budget fields (max_entries /
#: max_bytes / ttl_seconds).  v1 manifests load unchanged — absent
#: fields keep their defaults — and are upgraded in place on the next
#: save (backward adoption; asserted in tests/test_torch_provenance.py).
MANIFEST_VERSION = 2
PLAN_MANIFEST_VERSION = 1
PLANS_SUBDIR = "plans"


class ProvenanceError(RuntimeError):
    """Base class for provenance failures."""


class ManifestError(ProvenanceError):
    """A cache manifest is unreadable, corrupted or from the future."""


class StaleCacheError(ProvenanceError):
    """A cache directory's recorded provenance does not match the
    pipeline being executed (see ``on_stale=`` for the policies)."""


# ---------------------------------------------------------------------------
# canonical encoding + digest
# ---------------------------------------------------------------------------
#
# Fingerprints must be identical across processes and machines, so the
# payload is serialized with an unambiguous, type-tagged encoding
# (Python's hash() is salted per process; pickle embeds memo indices).

def canonical_bytes(obj: Any) -> bytes:
    """Deterministic, type-tagged byte encoding of a nested value."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _encode(o: Any, out: bytearray) -> None:
    if o is None:
        out += b"n;"
    elif o is True:
        out += b"T;"
    elif o is False:
        out += b"F;"
    elif isinstance(o, (int, np.integer)):
        out += b"i%d;" % int(o)
    elif isinstance(o, (float, np.floating)):
        out += b"f" + float(o).hex().encode("ascii") + b";"
    elif isinstance(o, str):
        b = o.encode("utf-8")
        out += b"s%d:" % len(b) + b + b";"
    elif isinstance(o, (bytes, bytearray)):
        out += b"b%d:" % len(o) + bytes(o) + b";"
    elif isinstance(o, (tuple, list)):
        out += b"("
        for e in o:
            _encode(e, out)
        out += b")"
    elif isinstance(o, (set, frozenset)):
        out += b"{"
        for e in sorted(o, key=repr):
            _encode(e, out)
        out += b"}"
    elif isinstance(o, dict):
        out += b"<"
        for k in sorted(o, key=repr):
            _encode(k, out)
            _encode(o[k], out)
        out += b">"
    else:
        r = repr(o).encode("utf-8")
        out += b"o%d:" % len(r) + r + b";"


# Constants mirror kernels/cachekey_hash/ref.py — the host digest below
# is the kernel's bit-identical reference ("shared cache entries").
_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_LANE2_OFFSET = 0x31415927

#: digests pad token buffers to multiples of this many uint32 words, as
#: the reference does, so equal payloads give equal kernel inputs
_WORD_BUCKET = 64

#: where digests run: "cuda" (default — the ``cachekey_hash`` kernel on
#: the card) or "cpu" (its plain PyTorch version), set by the caller
_DIGEST_DEVICE = "cuda"


def set_digest_device(device: str) -> str:
    """Choose where :func:`digest_bytes` runs: ``"cuda"`` (the default,
    the ``cachekey_hash`` kernel) or ``"cpu"`` (the kernel's plain
    version, for callers that run the port on the CPU).  Returns the
    previous setting.  Both give identical digests."""
    global _DIGEST_DEVICE
    if device not in ("cuda", "cpu"):
        raise ValueError(f"digest device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    prev, _DIGEST_DEVICE = _DIGEST_DEVICE, device
    return prev


def _host_digest(words: np.ndarray) -> bytes:
    """Pure-Python dual-lane FNV-1a over little-endian uint32 words
    (identical to ``kernels.cachekey_hash.ops.host_cachekey``).  The
    yardstick the kernel is held against; no digest path uses it."""
    h0, h1 = _FNV_OFFSET, _LANE2_OFFSET
    for b in np.ascontiguousarray(words, dtype="<u4").tobytes():
        h0 = ((h0 ^ b) * _FNV_PRIME) & 0xFFFFFFFF
        h1 = ((h1 ^ b) * _FNV_PRIME) & 0xFFFFFFFF
    return h0.to_bytes(4, "little") + h1.to_bytes(4, "little")


def _kernel_digest(words: np.ndarray) -> bytes:
    """One row through ``cachekey_hash_op`` on the digest device: one
    host-to-device copy, one launch, one device-to-host copy."""
    from ..device import resolve_device
    from ..kernels.cachekey_hash.ops import cachekey_hash_op
    tokens = torch.from_numpy(
        np.array(words, dtype="<u4").view(np.int32)
        .reshape(1, -1)).to(resolve_device(_DIGEST_DEVICE))
    out = cachekey_hash_op(tokens).cpu().numpy()
    return out.astype("<i4").tobytes()       # lane 0 then lane 1, LE


def digest_bytes(data: bytes) -> str:
    """16-hex-char dual-lane FNV digest of ``data`` (length-prefixed,
    zero-padded to the kernel's word bucket)."""
    buf = len(data).to_bytes(8, "little") + data
    buf += b"\x00" * ((-len(buf)) % 4)
    words = np.frombuffer(buf, dtype="<u4")
    target = -(-len(words) // _WORD_BUCKET) * _WORD_BUCKET
    if target > len(words):
        words = np.concatenate(
            [words, np.zeros(target - len(words), dtype="<u4")])
    return _kernel_digest(words).hex()


# ---------------------------------------------------------------------------
# transformer / node fingerprints
# ---------------------------------------------------------------------------

_SOURCE_HASH_CACHE: Dict[type, str] = {}


def class_source_hash(cls: type) -> str:
    """Short hash of a class's source text ("" when unobtainable) —
    folds *code changes* into provenance, per the paper's warning."""
    h = _SOURCE_HASH_CACHE.get(cls)
    if h is None:
        try:
            import inspect
            h = hashlib.sha256(
                inspect.getsource(cls).encode("utf-8")).hexdigest()[:16]
        except Exception:
            h = ""
        _SOURCE_HASH_CACHE[cls] = h
    return h


def transformer_fingerprint(t: Any) -> str:
    """Stable provenance fingerprint of a transformer.

    Covers class identity (module + qualname + source hash), the
    structural ``signature()`` (configuration and, for composite
    transformers, the whole subtree), and ``fingerprint_extras()`` when
    the transformer defines it (declare corpus versions, checkpoint
    paths, anything behaviour-relevant that the signature misses).
    Only as stable as the signature: signatures embedding ``id()`` or
    default ``object.__repr__`` addresses yield per-process values.
    """
    cls = type(t)
    sig = t.signature() if hasattr(t, "signature") else repr(t)
    extras: Tuple = ()
    fe = getattr(t, "fingerprint_extras", None)
    if callable(fe):
        extras = tuple(fe())
    payload = ("transformer/v1", cls.__module__, cls.__qualname__,
               class_source_hash(cls), sig, extras)
    return digest_bytes(canonical_bytes(payload))


def combine_fingerprints(*parts: Any) -> str:
    """Fold fingerprints/tokens into one digest (plan-node provenance:
    a node's fingerprint folds its stage's over its inputs')."""
    return digest_bytes(canonical_bytes(("combine/v1",) + parts))


# ---------------------------------------------------------------------------
# cache-dir manifests
# ---------------------------------------------------------------------------

def manifest_path(dirpath: str) -> str:
    return os.path.join(dirpath, MANIFEST_NAME)


@dataclass
class CacheManifest:
    """The versioned ``manifest.json`` of one cache directory."""

    family: str = ""                       # cache class (KeyValueCache, ...)
    backend: Optional[str] = None          # storage backend registry name
    fingerprint: Optional[str] = None      # provenance fingerprint (or None)
    transformer: Optional[str] = None      # repr of the wrapped transformer
    key_columns: List[str] = field(default_factory=list)
    value_columns: List[str] = field(default_factory=list)
    created_at: float = 0.0
    last_used_at: float = 0.0
    entry_count: int = 0
    # -- cache-economics budgets (v2; all optional, None = unbounded) ------
    max_entries: Optional[int] = None      # entry-count budget
    max_bytes: Optional[int] = None        # store-size budget (bytes)
    ttl_seconds: Optional[float] = None    # entry time-to-live
    # -- serialization scheme (see caching/codecs.py) ----------------------
    #: recorded when a store is *created*; ``None`` (including every
    #: directory that predates the field) means the legacy pickled
    #: keys/values scheme, so pre-existing warm dirs stay warm.  An
    #: optional field rather than a version bump: older builds load a
    #: manifest that carries it (unknown fields are filtered out on
    #: load) and keep serving the directory with whatever scheme the
    #: family negotiates.
    codec: Optional[str] = None
    format_version: int = MANIFEST_VERSION

    @classmethod
    def new(cls, **kw) -> "CacheManifest":
        now = time.time()
        return cls(created_at=now, last_used_at=now, **kw)

    def has_budget(self) -> bool:
        return (self.max_entries is not None or self.max_bytes is not None
                or self.ttl_seconds is not None)

    # -- integrity ---------------------------------------------------------
    def body(self) -> Dict[str, Any]:
        return asdict(self)

    def checksum(self) -> str:
        return _body_checksum(self.body())

    # -- io ----------------------------------------------------------------
    def save(self, dirpath: str) -> str:
        # older schemas upgrade to the current one on write (v1 dirs
        # adopt v2 the first time a v2 build touches them); a *future*
        # version is left intact so load() still rejects it
        if self.format_version < MANIFEST_VERSION:
            self.format_version = MANIFEST_VERSION
        doc = self.body()
        doc["checksum"] = self.checksum()
        path = manifest_path(dirpath)
        atomic_write_bytes(
            path, json.dumps(doc, indent=2, sort_keys=True).encode("utf-8"))
        return path

    @classmethod
    def load(cls, dirpath: str) -> Optional["CacheManifest"]:
        """Load a directory's manifest; ``None`` when absent.

        Raises :class:`ManifestError` on unparseable JSON, a checksum
        mismatch (hand-edited / torn manifest) or a format version
        newer than this code understands.
        """
        path = manifest_path(dirpath)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise ManifestError(f"unreadable cache manifest {path!r}: {e}")
        if not isinstance(doc, dict):
            raise ManifestError(f"cache manifest {path!r} is not an object")
        recorded = doc.pop("checksum", None)
        if recorded != _body_checksum(doc):
            raise ManifestError(
                f"corrupted cache manifest {path!r}: checksum mismatch "
                f"(the file was edited by hand or torn mid-write)")
        ver = doc.get("format_version")
        if not isinstance(ver, int) or ver > MANIFEST_VERSION:
            raise ManifestError(
                f"cache manifest {path!r} has format_version {ver!r}; this "
                f"build understands <= {MANIFEST_VERSION}")
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in known})


def _body_checksum(body: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode("utf-8")).hexdigest()


# ---------------------------------------------------------------------------
# plan manifests (a cache_dir is self-describing about the plans using it)
# ---------------------------------------------------------------------------

def plan_manifest_dir(cache_dir: str) -> str:
    return os.path.join(cache_dir, PLANS_SUBDIR)


def save_plan_manifest(cache_dir: str, record: Dict[str, Any]) -> str:
    """Write one plan's manifest under ``<cache_dir>/plans/<plan_id>.json``
    (atomic; re-planning the same pipeline set overwrites in place)."""
    d = plan_manifest_dir(cache_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{record['plan_id']}.json")
    atomic_write_bytes(
        path, json.dumps(record, indent=2, sort_keys=True).encode("utf-8"))
    return path


def iter_plan_manifests(cache_dir: str):
    """Yield ``(path, record_or_None, error_or_None)`` for every plan
    manifest under ``cache_dir`` (unparseable files yield an error)."""
    d = plan_manifest_dir(cache_dir)
    if not os.path.isdir(d):
        return
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(d, name)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError("not a JSON object")
        except (OSError, ValueError) as e:
            yield path, None, f"unreadable plan manifest: {e}"
            continue
        yield path, doc, None
