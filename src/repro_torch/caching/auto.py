"""Fingerprint derivation for the plan compiler.

Counterpart of the part of ``repro.caching.auto`` that the plan
compiler's cost layer uses (``core/cost.compute_node_fingerprints``).
``auto_cache`` — inferring a cache family from a transformer's
metadata — comes with the port's plan-inserted caches.
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = ["derive_fingerprint"]


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
