"""Declarative pipeline algebra (the paper's §2.1 operator language).

Counterpart of ``repro.core.pipeline``.  The planner and optimizer that
the comments below name (``core/plan.py``, ``core/rewrite.py``) are the
reference package's; this package ports them in a later slice.

Transformers are relations→relations functions combined with operators:

    >>   then / compose            %    rank cutoff
    +    linear combine            *    scalar product
    **   feature union             |    set union
    &    set intersection          ^    concatenate

Design points carried from the paper:
  * the *conceptual* pipeline is an expression tree; ``t % k`` is sugar
    for ``t >> RankCutoff(k)`` so that prefix precomputation (§3) can
    share ``t`` across pipelines with different cutoffs — exactly the
    demo experiment's structure;
  * transformers expose an equality property (structural ``signature()``)
    — the only requirement the paper's LCP algorithm places on them;
  * beyond the paper (§6 future work): transformers additionally declare
    ``key_columns`` / ``value_columns`` / ``deterministic`` /
    ``cacheable`` so caching strategies can be *inferred* and pipelines
    statically type-checked.
"""
from __future__ import annotations

import hashlib
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .frame import ColFrame

__all__ = [
    "Transformer", "Indexer", "Compose", "RankCutoff", "LinearCombine",
    "ScalarProduct", "FeatureUnion", "SetUnion", "SetIntersection",
    "Concatenate", "Identity", "GenericTransformer", "SourceResults",
    "add_ranks", "stages_of", "pipeline_hash",
]


def _factorize(col: np.ndarray) -> np.ndarray:
    """Integer codes for a column.

    Keys are compared by string form — the same semantics as
    ``ColFrame.group_indices`` (``frame._row_codes``), so ``qid=1`` and
    ``qid="1"`` are one key throughout the algebra.  Q/R/RA relations
    in this codebase use string keys.
    """
    arr = np.asarray(col)
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        arr = arr.astype(str)
    _, inv = np.unique(arr, return_inverse=True)
    return inv.astype(np.int64)


def _score_sort_keys(scores: np.ndarray) -> np.ndarray:
    """Unsigned-integer keys whose ascending order is descending score
    (IEEE-754 total order trick) — integer sorts beat float sorts."""
    ub = np.ascontiguousarray(scores).view(np.uint64)
    asc = np.where(ub >> np.uint64(63) == np.uint64(1),
                   ~ub, ub | np.uint64(1 << 63))
    return ~asc


def _repair_tied_group(res: ColFrame, ranks: np.ndarray,
                       idx: np.ndarray) -> None:
    """Re-rank one qid group with the full (docno, -score) tie-break."""
    scores = res["score"][idx].astype(np.float64)
    docnos = np.asarray(res["docno"][idx], dtype=object).astype(str)
    order = np.lexsort((docnos, -scores))
    ranks[idx[order]] = np.arange(len(idx))


def add_ranks(res: ColFrame) -> ColFrame:
    """(Re-)assign the rank column: descending score per qid, stable
    (ties broken by docno, then original position).

    Vectorized (benchmarked in ``benchmarks/plan_bench.py``):

    * results arriving qid-blocked (the overwhelmingly common layout a
      retriever emits) are scattered into a padded (groups × depth)
      matrix and ranked with one row-wise argsort;
    * otherwise a global two-pass argsort on (integer score keys, qid
      codes) is used;
    * docno strings are only compared inside groups that actually
      contain score ties, so the hot path never touches them.
    """
    if len(res) == 0:
        return res.assign(rank=np.empty(0, dtype=np.int64)) if "rank" not in res \
            else res
    n = len(res)
    scores = np.ascontiguousarray(res["score"].astype(np.float64, copy=False))
    q = res["qid"]
    pos = np.arange(n, dtype=np.int64)
    change = np.empty(n, dtype=bool)
    change[0] = True
    change[1:] = q[1:] != q[:-1]
    starts = np.nonzero(change)[0]
    n_runs = len(starts)
    reps = np.asarray(q[change])
    if reps.dtype == object or reps.dtype.kind in ("U", "S"):
        reps = reps.astype(str)
    uniq, rinv = np.unique(reps, return_inverse=True)
    lengths = np.diff(np.append(starts, n))
    depth = int(lengths.max())

    if len(uniq) == n_runs and n_runs * depth <= 4 * n + 1024:
        # -- blocked fast path: every qid is one contiguous run ----------
        uniform = depth == int(lengths.min())
        if uniform:
            # uniform fan-out (top-k results): a zero-copy reshape
            mat = scores.reshape(n_runs, depth)
        else:
            run_id = np.repeat(np.arange(n_runs, dtype=np.int64), lengths)
            col = pos - np.repeat(starts, lengths)
            mat = np.full((n_runs, depth), np.nan)  # NaN pads sort last
            mat[run_id, col] = scores
        order2d = np.argsort(-mat, axis=1, kind="stable")
        rr = np.empty((n_runs, depth), dtype=order2d.dtype)
        np.put_along_axis(rr, order2d,
                          np.broadcast_to(np.arange(depth), (n_runs, depth)),
                          axis=1)
        ranks = rr.ravel().astype(np.int64, copy=False) if uniform \
            else rr[run_id, col].astype(np.int64, copy=False)
        srt = np.take_along_axis(mat, order2d, axis=1)
        tied_rows = np.nonzero((srt[:, 1:] == srt[:, :-1]).any(axis=1))[0]
        if len(tied_rows):
            ranks = np.ascontiguousarray(ranks)
            for r0 in tied_rows:
                idx = np.arange(starts[r0], starts[r0] + lengths[r0])
                _repair_tied_group(res, ranks, idx)
        return res.assign(rank=ranks)

    # -- general path: interleaved or heavily skewed groups --------------
    run_id = np.repeat(np.arange(n_runs, dtype=np.int64), lengths)
    qcodes = rinv.astype(np.int64)[run_id]
    o1 = np.argsort(_score_sort_keys(scores), kind="stable")
    o2 = np.argsort(qcodes[o1], kind="stable")
    order = o1[o2]
    qs = qcodes[order]
    ss = scores[order]
    tie = np.zeros(n, dtype=bool)
    tie[1:] = (qs[1:] == qs[:-1]) & (ss[1:] == ss[:-1])
    if tie.any():
        docnos = np.asarray(res["docno"], dtype=object)
        bounds = np.nonzero(np.diff(
            np.concatenate([[0], tie.view(np.int8), [0]])))[0]
        for i in range(0, len(bounds), 2):
            lo, hi = bounds[i] - 1, bounds[i + 1]
            sub = order[lo:hi]
            # (docno, original position): the explicit position key keeps
            # +0.0/-0.0 score ties in row order like the seed's lexsort
            order[lo:hi] = sub[np.lexsort((sub, docnos[sub].astype(str)))]
        qs = qcodes[order]
    new_block = np.empty(n, dtype=bool)
    new_block[0] = True
    new_block[1:] = qs[1:] != qs[:-1]
    block_start = np.maximum.accumulate(np.where(new_block, pos, 0))
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = pos - block_start
    return res.assign(rank=ranks)


class Transformer:
    """Base class for all pipeline stages."""

    #: required input / produced output columns (None = unconstrained)
    input_columns: Optional[frozenset] = None
    output_columns: Optional[frozenset] = None
    #: cache-strategy metadata (beyond-paper §6 future work)
    key_columns: Tuple[str, ...] = ()
    value_columns: Tuple[str, ...] = ()
    deterministic: bool = True
    cacheable: bool = True
    #: one-to-many stages (retrievers) need RetrieverCache not KeyValueCache
    one_to_many: bool = False
    #: row-local per qid: output for a qid group depends only on that
    #: group's rows.  Stages computing cross-query statistics (global
    #: score normalization, corpus-level IDF updates, ...) must declare
    #: ``shardable=False`` — the concurrent executor then refuses to
    #: partition the query frame (``core/plan.py``), like ``batch_size``
    #: callers must refuse to batch them.
    shardable: bool = True
    #: declares that ``RankCutoff`` commutes through this stage: it is a
    #: per-row mapping (rows 1:1, no reordering) that preserves the
    #: per-qid ranking — same (qid, docno, rank) — so ``t >> X >> % k``
    #: equals ``t >> % k >> X``.  The optimizer (``core/rewrite.py``)
    #: uses this to push rank cutoffs toward retrievers.  Stages whose
    #: score map can reorder ties must leave this False.
    rank_preserving: bool = False
    #: declares that the output is the input frame plus extra columns —
    #: existing columns, row count and row order are untouched (e.g. a
    #: text loader).  Implies ``rank_preserving``-like row stability and
    #: lets cache-aware pruning defer the stage behind a warm
    #: downstream cache whose keys the stage cannot alter.
    augment_only: bool = False

    # -- execution -----------------------------------------------------
    def transform(self, inp: ColFrame) -> ColFrame:
        raise NotImplementedError

    def __call__(self, inp: Any) -> ColFrame:
        frame = ColFrame.coerce(inp)
        if self.input_columns is not None:
            missing = self.input_columns - set(frame.columns)
            if missing and len(frame):
                raise TypeError(
                    f"{self!r} expected columns {sorted(self.input_columns)}, "
                    f"missing {sorted(missing)}")
        return self.transform(frame)

    # -- structural identity (paper §3: equality is all LCP needs) ------
    def signature(self) -> Tuple:
        return (type(self).__name__,)

    # -- provenance (beyond paper: cache invalidation) -------------------
    def fingerprint(self) -> str:
        """Stable provenance fingerprint of ``signature()`` and
        ``fingerprint_extras()``.  The digest is computed by the
        ``cachekey_hash`` kernel (``repro.caching.provenance``), which
        this package ports together with the plan compiler and the
        cache families; until then there is no fingerprint."""
        raise NotImplementedError(
            "Transformer.fingerprint() needs provenance and the "
            "cachekey_hash kernel, which arrive with the plan-compiler "
            "and cache slice of repro_torch")

    def fingerprint_extras(self) -> Tuple:
        """Extra provenance tokens folded into ``fingerprint()``.

        Override to declare behaviour-relevant state the signature
        misses — corpus versions, checkpoint paths, model revisions —
        so caches of this transformer invalidate when they change."""
        return ()

    # -- optimizer hooks (core/rewrite.py) -------------------------------
    def with_cutoff(self, k: int) -> Optional["Transformer"]:
        """Absorb a downstream ``RankCutoff(k)``: return a transformer
        equivalent to ``self >> RankCutoff(k)`` (return ``self`` when
        this stage already emits at most ``k`` results per query), or
        ``None`` when the cutoff cannot be absorbed.  Retrievers with a
        ``num_results`` knob override this so the optimizer's pushdown
        pass fuses ``% k`` into the retrieval depth itself."""
        return None

    def __eq__(self, other) -> bool:
        return isinstance(other, Transformer) and self.signature() == other.signature()

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return hash(self.signature())

    def __repr__(self) -> str:
        return f"{type(self).__name__}{self.signature()[1:]}"

    # -- operator language ----------------------------------------------
    def __rshift__(self, other: "Transformer") -> "Compose":
        return Compose([self, other])

    def __mod__(self, k: int) -> "Compose":
        return Compose([self, RankCutoff(int(k))])

    def __add__(self, other: "Transformer") -> "LinearCombine":
        return LinearCombine(self, other)

    def __mul__(self, scalar: float) -> "ScalarProduct":
        return ScalarProduct(self, float(scalar))

    __rmul__ = __mul__

    def __pow__(self, other: "Transformer") -> "FeatureUnion":
        return FeatureUnion(self, other)

    def __or__(self, other: "Transformer") -> "SetUnion":
        return SetUnion(self, other)

    def __and__(self, other: "Transformer") -> "SetIntersection":
        return SetIntersection(self, other)

    def __xor__(self, other: "Transformer") -> "Concatenate":
        return Concatenate(self, other)


class Indexer(Transformer):
    """Terminal stage (D → ∅): consumes a corpus stream."""

    def index(self, corpus_iter: Iterable[dict]) -> Any:
        raise NotImplementedError

    def transform(self, inp: ColFrame) -> ColFrame:
        self.index(inp.to_dicts())
        return ColFrame()


class Compose(Transformer):
    """``>>`` — sequential composition; flattens nested composes."""

    def __init__(self, stages: Sequence[Transformer]):
        flat: List[Transformer] = []
        for s in stages:
            if isinstance(s, Compose):
                flat.extend(s.stages)
            else:
                flat.append(s)
        self.stages: Tuple[Transformer, ...] = tuple(flat)

    def transform(self, inp: ColFrame) -> ColFrame:
        out = inp
        for s in self.stages:
            out = s(out)
        return out

    def signature(self) -> Tuple:
        return ("Compose",) + tuple(s.signature() for s in self.stages)

    def __repr__(self) -> str:
        return " >> ".join(repr(s) for s in self.stages)

    def index(self, corpus_iter: Iterable[dict]):
        """Indexing pipeline: pass the stream through non-terminal stages,
        then hand it to the terminal indexer (paper §4.1/§4.4 usage)."""
        *head, last = self.stages
        stream: Iterable[dict] = corpus_iter

        def _apply(stage, it):
            frame = ColFrame.from_dicts(it)
            return stage(frame).to_dicts()

        for stage in head:
            if hasattr(stage, "transform_iter"):
                stream = stage.transform_iter(stream)
            else:
                stream = _apply(stage, stream)
        if not isinstance(last, Indexer) and not hasattr(last, "index"):
            raise TypeError(f"last stage of an indexing pipeline must be an "
                            f"Indexer, got {last!r}")
        return last.index(stream)


class RankCutoff(Transformer):
    """``% k`` — keep the top-k rows per query (by rank, else score)."""

    input_columns = frozenset({"qid", "docno", "score"})
    key_columns = ("qid",)

    def __init__(self, k: int):
        self.k = int(k)

    def transform(self, inp: ColFrame) -> ColFrame:
        if len(inp) == 0:
            return inp
        res = inp if "rank" in inp else add_ranks(inp)
        keep = res["rank"] < self.k
        return res.mask(keep)

    def signature(self) -> Tuple:
        return ("RankCutoff", self.k)

    def with_cutoff(self, k: int) -> "RankCutoff":
        """``% j >> % k`` is ``% min(j, k)``."""
        return self if min(self.k, int(k)) == self.k \
            else RankCutoff(min(self.k, int(k)))


class _Binary(Transformer):
    """Binary operator node.

    ``transform`` evaluates both children then delegates to
    ``combine(a, b)``; the execution planner (``core/plan.py``) calls
    ``combine`` directly on shared child results, so a retriever shared
    under ``a + b`` and ``a ** c`` executes once.

    ``commutative=True`` declares ``combine(a, b)`` and ``combine(b, a)``
    produce the same per-qid relation — same (qid, docno) rows with the
    same scores/ranks, though possibly in a different row order — which
    lets the optimizer's normalize pass share ``a + b`` with ``b + a``.
    """

    #: combine(a, b) == combine(b, a) up to row order
    commutative: bool = False

    def __init__(self, left: Transformer, right: Transformer):
        self.left = left
        self.right = right

    def signature(self) -> Tuple:
        return (type(self).__name__, self.left.signature(), self.right.signature())

    def transform(self, inp: ColFrame) -> ColFrame:
        return self.combine(self.left(inp), self.right(inp))

    def combine(self, a: ColFrame, b: ColFrame) -> ColFrame:
        raise NotImplementedError


class LinearCombine(_Binary):
    """``+`` — sum query-document scores of the two result lists."""

    commutative = True                   # x + y == y + x per (qid, docno)

    def combine(self, a: ColFrame, b: ColFrame) -> ColFrame:
        return _combine_scores(a, b, lambda x, y: x + y)


class ScalarProduct(Transformer):
    """``*`` — multiply scores by a scalar."""

    def __init__(self, inner: Transformer, scalar: float):
        self.inner = inner
        self.scalar = scalar

    def transform(self, inp: ColFrame) -> ColFrame:
        return self.apply(self.inner(inp))

    def apply(self, res: ColFrame) -> ColFrame:
        """Post-child work (planner entry point, like _Binary.combine)."""
        return add_ranks(res.assign(score=res["score"] * self.scalar))

    def signature(self) -> Tuple:
        return ("ScalarProduct", self.inner.signature(), self.scalar)


class FeatureUnion(_Binary):
    """``**`` — combine the two result lists as a features column."""

    def combine(self, a: ColFrame, b: ColFrame) -> ColFrame:
        qids, docnos, sa, sb = _aligned_scores(a, b)
        feats = np.empty(len(qids), dtype=object)
        if len(qids):
            feats[:] = list(np.stack([sa, sb], axis=1))
        out = ColFrame({"qid": qids, "docno": docnos,
                        "score": sa.copy(), "features": feats})
        return add_ranks(out)


class SetUnion(_Binary):
    """``|`` — set union of documents (scores/ranks dropped)."""

    commutative = True                   # same (qid, docno) set either way

    def combine(self, a: ColFrame, b: ColFrame) -> ColFrame:
        merged = ColFrame.concat([a, b])
        keep = [c for c in merged.columns if c not in ("score", "rank")]
        return merged.select(keep).dedup(["qid", "docno"])


class SetIntersection(_Binary):
    """``&`` — set intersection of documents (scores/ranks dropped)."""

    def combine(self, a: ColFrame, b: ColFrame) -> ColFrame:
        mask = _key_membership(a, b) if len(a) and len(b) else \
            np.zeros(len(a), dtype=bool)
        keep = [c for c in a.columns if c not in ("score", "rank")]
        return a.mask(mask).select(keep).dedup(["qid", "docno"])


class Concatenate(_Binary):
    """``^`` — append right results below the left results per query."""

    def combine(self, a: ColFrame, b: ColFrame) -> ColFrame:
        if len(a) == 0:
            return add_ranks(b)
        mask = ~_key_membership(b, a) if len(b) else \
            np.zeros(0, dtype=bool)
        b_new = b.mask(mask)
        # offset right scores so they sort strictly below the left block
        if len(b_new):
            qcodes = _factorize(_obj_concat(a["qid"], b_new["qid"]))
            qa, qb = qcodes[:len(a)], qcodes[len(a):]
            n_codes = int(qcodes.max()) + 1
            min_a = np.full(n_codes, np.inf)
            np.minimum.at(min_a, qa, a["score"].astype(np.float64))
            min_a[np.isinf(min_a)] = 0.0   # qids absent from a -> 0.0
            max_b = np.full(n_codes, -np.inf)
            np.maximum.at(max_b, qb, b_new["score"].astype(np.float64))
            shift = min_a[qb] - max_b[qb] - 1.0
            b_new = b_new.assign(score=b_new["score"] + shift)
        common = [c for c in a.columns if c in b_new.columns] or list(a.columns)
        out = ColFrame.concat([a.select(common), b_new.select(common)]) \
            if len(b_new) else a
        return add_ranks(out)


class Identity(Transformer):
    """Returns its input unchanged (paper §2.2's pass-through)."""

    def transform(self, inp: ColFrame) -> ColFrame:
        return inp


class SourceResults(Transformer):
    """A constant result set as a pipeline stage (paper §2.2's
    ``pt.Transformer.from_df(res)`` pattern): joins the stored results
    back onto the incoming queries."""

    def __init__(self, results: ColFrame, name: str = "source"):
        self.results = results
        self.name = name

    def transform(self, inp: ColFrame) -> ColFrame:
        if len(inp) == 0 or "qid" not in inp:
            return self.results
        qids = set(inp["qid"].tolist())
        mask = np.array([q in qids for q in self.results["qid"].tolist()],
                        dtype=bool)
        return self.results.mask(mask)

    def signature(self) -> Tuple:
        return ("SourceResults", self.name, len(self.results))


class GenericTransformer(Transformer):
    """Wrap a plain function as a transformer (named for equality)."""

    def __init__(self, fn, name: str, *, key_columns=(), value_columns=(),
                 one_to_many=False, cacheable=True, deterministic=True,
                 shardable=True, rank_preserving=False, augment_only=False,
                 params: Tuple = ()):
        self.fn = fn
        self.name = name
        self.params = tuple(params)
        self.key_columns = tuple(key_columns)
        self.value_columns = tuple(value_columns)
        self.one_to_many = one_to_many
        self.cacheable = cacheable
        self.deterministic = deterministic
        self.shardable = shardable
        self.rank_preserving = rank_preserving
        self.augment_only = augment_only

    def transform(self, inp: ColFrame) -> ColFrame:
        return ColFrame.coerce(self.fn(inp))

    def signature(self) -> Tuple:
        return ("GenericTransformer", self.name) + self.params


def _obj_concat(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    out = np.empty(len(x) + len(y), dtype=object)
    out[:len(x)] = x
    out[len(x):] = y
    return out


def _merged_keys(a: ColFrame, b: ColFrame
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenated (qid, docno) columns of a and b plus integer codes
    identifying distinct key pairs across both frames."""
    merged_q = _obj_concat(a["qid"], b["qid"])
    merged_d = _obj_concat(a["docno"], b["docno"])
    qcodes = _factorize(merged_q)
    dcodes = _factorize(merged_d)
    return merged_q, merged_d, \
        qcodes * (int(dcodes.max(initial=0)) + 1) + dcodes


def _key_membership(a: ColFrame, b: ColFrame) -> np.ndarray:
    """Boolean mask: which rows of ``a`` have their (qid, docno) in ``b``."""
    _, _, codes = _merged_keys(a, b)
    return np.isin(codes[:len(a)], codes[len(a):])


def _aligned_scores(a: ColFrame, b: ColFrame
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Row-align two result frames on (qid, docno), vectorized.

    Returns ``(qids, docnos, scores_a, scores_b)`` over the union of
    keys in first-occurrence order (a's rows, then b's new keys);
    missing scores are 0.0 and duplicate keys within one frame keep the
    last score — the exact semantics of the seed's dict-based loop,
    without per-key Python work.
    """
    na, nb = len(a), len(b)
    if na + nb == 0:
        e = np.empty(0, dtype=object)
        return e, e.copy(), np.empty(0), np.empty(0)
    merged_q, merged_d, codes = _merged_keys(a, b)
    uniq, first, inv = np.unique(codes, return_index=True, return_inverse=True)
    perm = np.argsort(first, kind="stable")      # sorted-uniq -> output order
    inv_perm = np.empty(len(perm), dtype=np.int64)
    inv_perm[perm] = np.arange(len(perm))
    slot = inv_perm[inv]                          # row -> output slot
    k = len(uniq)
    sa = np.zeros(k)
    sb = np.zeros(k)
    if na:
        sa[slot[:na]] = a["score"].astype(np.float64)   # dup keys: last wins
    if nb:
        sb[slot[na:]] = b["score"].astype(np.float64)
    rep = first[perm]                             # first occurrence per key
    return merged_q[rep], merged_d[rep], sa, sb


def _combine_scores(a: ColFrame, b: ColFrame, op) -> ColFrame:
    qids, docnos, sa, sb = _aligned_scores(a, b)
    scores = np.asarray(op(sa, sb), dtype=np.float64)
    return add_ranks(ColFrame({"qid": qids, "docno": docnos, "score": scores}))


# ---------------------------------------------------------------------------
# pipeline introspection helpers (used by precompute + caches)
# ---------------------------------------------------------------------------

def stages_of(pipeline: Transformer) -> Tuple[Transformer, ...]:
    """The sequential stage decomposition used by LCP (Compose chains
    decompose; every other node is a single opaque stage)."""
    if isinstance(pipeline, Compose):
        return pipeline.stages
    return (pipeline,)


def pipeline_hash(t: Transformer) -> str:
    """Stable hex digest of a transformer's structural signature."""
    return hashlib.sha256(repr(t.signature()).encode()).hexdigest()[:16]
