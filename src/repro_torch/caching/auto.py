"""Fingerprint derivation for the plan compiler.

Counterpart of the part of ``repro.caching.auto`` that the plan
compiler's cost layer uses (``core/cost.plan_fingerprints``):
``derive_fingerprint``, and ``fingerprint_request``, which lets that
layer digest a plan's stage fingerprints in one batch.
``auto_cache`` — inferring a cache family from a transformer's
metadata — comes with the port's plan-inserted caches.
"""
from __future__ import annotations

from typing import Any, Optional, Union

__all__ = ["derive_fingerprint", "fingerprint_request"]


def derive_fingerprint(transformer: Any) -> Optional[str]:
    """``transformer.fingerprint()`` when safely derivable, else None
    (no transformer, unconstructed ``Lazy`` — whose placeholder
    signature would change once constructed — or a failing hook)."""
    if transformer is None:
        return None
    if hasattr(transformer, "_resolve_lazy"):
        if not getattr(transformer, "constructed", True):
            return None
        transformer = transformer._resolve_lazy()    # already built: free
    try:
        return transformer.fingerprint()
    except Exception:
        return None


def fingerprint_request(transformer: Any) -> Union[bytes, str, None]:
    """What :func:`derive_fingerprint` digests, for batching: the payload
    bytes of the default ``Transformer.fingerprint()`` (its digest is
    ``digest_bytes`` of them), the finished fingerprint where the class
    overrides ``fingerprint()`` (it is asked directly), or None where
    ``derive_fingerprint`` gives None."""
    from ..core.pipeline import Transformer
    from .provenance import fingerprint_payload
    if transformer is None:
        return None
    if hasattr(transformer, "_resolve_lazy"):
        if not getattr(transformer, "constructed", True):
            return None
        transformer = transformer._resolve_lazy()
    try:
        if getattr(type(transformer), "fingerprint", None) is \
                Transformer.fingerprint:
            return fingerprint_payload(transformer)
        return transformer.fingerprint()
    except Exception:
        return None
