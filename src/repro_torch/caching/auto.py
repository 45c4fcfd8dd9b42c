"""auto_cache — inferring the caching strategy (paper §6 future work).

Counterpart of ``repro.caching.auto``, plus ``fingerprint_request``,
which lets the plan compiler's cost layer (``core/cost.plan_fingerprints``)
digest a plan's stage fingerprints in one batch.

The paper notes explicit caches "rely on direct application by the
researcher ... since current transformer implementations do not provide
sufficient information to automatically infer the correct caching
strategy.  In the future, we may enhance the Transformer API to include
this kind of information, e.g. the input and output columns."

Our Transformer base class carries exactly that metadata
(``key_columns`` / ``value_columns`` / ``one_to_many`` / ``cacheable`` /
``deterministic``), so the inference is implementable:

* ``cacheable=False``  → refuse (pairwise/listwise scorers, adaptive
  rerankers — §5's DuoT5 caveat);
* ``one_to_many=True`` → RetrieverCache keyed by ``key_columns``;
* ``score`` among the value columns → ScorerCache (re-ranks after merge);
* otherwise            → KeyValueCache on (key_columns → value_columns).

The same metadata powers ``typecheck_pipeline`` — the "added benefit"
footnote 13 anticipates (automatic type-checking of pipelines).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

from ..core.frame import ColFrame
from ..core.pipeline import Compose, Transformer, stages_of
from .kv import KeyValueCache
from .retriever import RetrieverCache
from .scorer import ScorerCache

__all__ = ["auto_cache", "auto_cache_or_none", "derive_fingerprint",
           "fingerprint_request", "typecheck_pipeline", "UncacheableError"]


class UncacheableError(TypeError):
    pass


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


def auto_cache(transformer: Transformer, path: Optional[str] = None,
               *, backend: Optional[str] = None,
               fingerprint: Optional[str] = None,
               on_stale: Optional[str] = None,
               budget: Any = None, **kwargs):
    """Pick and construct the right cache family from metadata.

    ``backend`` selects the storage implementation by registry name
    (``"memory"`` / ``"pickle"`` / ``"dbm"`` / ``"sqlite"``, plus the
    ``"tiered[:<disk>]"`` combinator — see ``backends.py``); ``None``
    keeps each family's default (SQLite for key-value/scorer caches,
    dbm for retriever caches, both per §4).  ``budget`` bounds the
    store (``economics.CacheBudget`` / dict / int max-entries) —
    recorded in the manifest and enforced on ``close()`` or by
    ``economics.enforce_dir``.

    Provenance (``caching/provenance.py``): ``fingerprint`` defaults to
    ``transformer.fingerprint()`` (skipped for unconstructed ``Lazy``
    wrappers — deriving it would force construction), so reopening a
    cache directory after the transformer's config or code changed
    trips the ``on_stale`` policy (``"error"`` | ``"recompute"`` |
    ``"readonly"``) instead of silently serving stale results.
    """
    if backend is not None:
        kwargs["backend"] = backend
    if on_stale is not None:
        kwargs["on_stale"] = on_stale
    if budget is not None:
        kwargs["budget"] = budget        # size/TTL envelope (economics.py)
    if fingerprint is None:
        fingerprint = derive_fingerprint(transformer)
    if fingerprint is not None:
        kwargs["fingerprint"] = fingerprint
    if isinstance(transformer, Compose):
        raise UncacheableError(
            "auto_cache wraps a single stage; wrap stages individually or "
            "rely on prefix precomputation for whole-pipeline sharing")
    if not getattr(transformer, "cacheable", True):
        raise UncacheableError(
            f"{transformer!r} declares cacheable=False (its outputs depend "
            f"on the candidate pool, like DuoT5 — see paper §5)")
    if not getattr(transformer, "deterministic", True):
        raise UncacheableError(
            f"{transformer!r} declares deterministic=False; caching would "
            f"freeze one sample of a stochastic process")
    keys = tuple(getattr(transformer, "key_columns", ()) or ())
    vals = tuple(getattr(transformer, "value_columns", ()) or ())
    if getattr(transformer, "one_to_many", False):
        return RetrieverCache(path, transformer,
                              key=keys or ("qid", "query"), **kwargs)
    if "score" in vals or (not vals and "docno" in keys):
        # only stages that *produce* a score are scorers — a docno-keyed
        # augmenter (TextLoader: docno → text) must not be re-ranked, and
        # after SetUnion its input has no score column to fall back on
        return ScorerCache(path, transformer,
                           key=keys or ("query", "docno"),
                           value=vals or ("score",), **kwargs)
    if not keys or not vals:
        raise UncacheableError(
            f"{transformer!r} does not declare key/value columns; cannot "
            f"infer a caching strategy (the paper-§6 situation)")
    return KeyValueCache(path, transformer, key=keys, value=vals, **kwargs)


def auto_cache_or_none(transformer: Transformer, path: Optional[str] = None,
                       **kwargs):
    """``auto_cache`` as a *policy*: ``None`` instead of an exception.

    This is the default ``memo_factory`` of ``core.plan.ExecutionPlan``
    — nodes whose metadata admits a caching strategy get one inserted by
    the planner; everything else (uncacheable, nondeterministic,
    already-cached, undeclared) runs bare.  Accepts the same
    ``backend=`` selector as ``auto_cache`` (the planner forwards its
    ``cache_backend`` argument here).
    """
    from .base import CacheTransformer
    if isinstance(transformer, (Compose, CacheTransformer)):
        return None
    try:
        return auto_cache(transformer, path, **kwargs)
    except UncacheableError:
        return None


def typecheck_pipeline(pipeline: Transformer) -> List[Tuple[str, str]]:
    """Static column-flow check along a Compose chain.

    Returns a list of (stage repr, error) — empty when well-typed.
    Uses the declared input/output column sets; stages without
    declarations pass through unchanged columns conservatively.
    """
    errors: List[Tuple[str, str]] = []
    available: Optional[set] = None  # None = unknown/any
    for stage in stages_of(pipeline):
        need = getattr(stage, "input_columns", None)
        if need is not None and available is not None:
            missing = set(need) - available
            if missing:
                errors.append((repr(stage),
                               f"missing input columns {sorted(missing)} "
                               f"(have {sorted(available)})"))
        out_cols = getattr(stage, "output_columns", None)
        if out_cols is not None:
            available = set(out_cols)
        else:
            produced = set(getattr(stage, "value_columns", ()) or ())
            if available is not None:
                available = available | produced
            if need is not None and available is None:
                available = set(need) | produced
    return errors
