"""Toy stages built alike in the reference (``repro``) and the port
(``repro_torch``), for the port's parity tests: the same pipelines over
the same queries, in each package's own algebra."""
from types import SimpleNamespace

import numpy as np

QUERY_ROWS = {"qid": ["q1", "q2", "q3"],
              "query": ["alpha", "beta", "gamma"]}
SORT = ["qid", "docno"]


def toy(core):
    """Stages of ``core`` (``repro.core`` or ``repro_torch.core``)."""

    class CutRetriever(core.Transformer):
        """Deterministic retriever with an absorbable depth knob."""

        key_columns = ("qid", "query")
        one_to_many = True

        def __init__(self, name, n=6, base=100.0):
            self.name, self.n, self.base = name, int(n), float(base)

        def signature(self):
            return ("CutRetriever", self.name, self.n, self.base)

        def with_cutoff(self, k):
            return self if int(k) >= self.n \
                else CutRetriever(self.name, int(k), self.base)

        def transform(self, inp):
            rows = [{"qid": q, "query": t,
                     "docno": f"{self.name}_d{i:02d}",
                     "score": self.base - i, "rank": i}
                    for q, t in zip(inp["qid"].tolist(),
                                    inp["query"].tolist())
                    for i in range(self.n)]
            return core.ColFrame.from_dicts(rows) if rows else inp.head(0)

    class Counting(core.GenericTransformer):
        def __init__(self, name, fn=None, **kw):
            self.calls = 0

            def wrapped(inp, _fn=fn):
                self.calls += 1
                return _fn(inp) if _fn else inp
            super().__init__(wrapped, name, **kw)

    def retriever(name, n=4, base=10.0):
        def fn(inp):
            rows = [{"qid": q, "query": t, "docno": f"{name}_d{i}",
                     "score": base - i}
                    for q, t in zip(inp["qid"].tolist(),
                                    inp["query"].tolist())
                    for i in range(n)]
            return core.add_ranks(core.ColFrame.from_dicts(rows))
        return Counting(name, fn, one_to_many=True,
                        key_columns=("qid", "query"))

    def boost(name="boost", factor=2.0):
        """Strictly monotone per-row score map — rank-preserving."""
        def fn(inp, _f=factor):
            return core.add_ranks(inp.assign(score=inp["score"] * _f))
        return Counting(name, fn, rank_preserving=True)

    def docno_scorer(name, mult=1.0):
        """Score from the docno (works on score-less frames)."""
        def fn(inp, _m=mult):
            scores = np.array([float(ord(d[-1]) + len(d)) * _m
                               for d in inp["docno"].tolist()])
            return core.add_ranks(inp.assign(score=scores))
        return Counting(name, fn)

    return SimpleNamespace(
        CutRetriever=CutRetriever, Counting=Counting, retriever=retriever,
        boost=boost, docno_scorer=docno_scorer,
        queries=lambda: core.ColFrame(dict(QUERY_ROWS)))


def pipeline_sets(t):
    """Named pipeline sets over the toy stages ``t`` (one of ``toy``)."""
    A, B, C = t.retriever("A"), t.boost("B"), t.docno_scorer("C")
    r1, r2 = t.retriever("r1", base=10.0), t.retriever("r2", base=7.0)
    cr = t.CutRetriever("cr", n=8)
    return {
        "ablation": [A, A >> B, A >> B >> C],
        "commutative": [(r1 + r2) >> t.boost("post"),
                        (r2 + r1) % 3,
                        r1 | r2, (r1 ** r2) % 2],
        "cutoffs": [cr % 3, cr >> t.boost("b2") % 5,
                    cr % 5 % 2, (cr % 4) ^ t.retriever("tail")],
        "mixed": [r1 % 2 >> C, (r1 & (r1 >> t.boost("bx"))) >> C,
                  2.0 * r1, r1 + r2, (r1 & r2) >> C],
    }


def frames_equal(a, b):
    """Equal (qid, docno, score, rank) values under canonical row order,
    for frames of either package.  Empty frames are equal whatever
    columns they kept (``ColFrame.concat`` of empty shards keeps none)."""
    if len(a) == 0 or len(b) == 0:
        return len(a) == len(b)
    cols = [c for c in ("qid", "docno", "score", "rank")
            if c in a.columns and c in b.columns]
    assert set(cols) >= {c for c in ("qid", "docno", "score", "rank")
                         if c in b.columns}
    by = [c for c in SORT if c in cols]
    a = a.sort_values(by) if by else a
    b = b.sort_values(by) if by else b
    if len(a) != len(b):
        return False
    for c in cols:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        if x.dtype.kind in "fiu" and y.dtype.kind in "fiu":
            if not np.array_equal(x.astype(np.float64),
                                  y.astype(np.float64)):
                return False
        elif [str(v) for v in x.tolist()] != [str(v) for v in y.tolist()]:
            return False
    return True


def fp_classes(fps):
    """Partition of node ids by equal fingerprint."""
    out = {}
    for nid, fp in fps.items():
        out.setdefault(fp, set()).add(nid)
    return sorted(sorted(v) for v in out.values())


def pin_round_trip(monkeypatch, seconds=1e-7):
    """Give both packages' ``cache-place`` one store round trip.  The
    measured one varies with the machine's load, and a stage as cheap
    as a ``TextLoader`` (a few µs a query) could then keep its cache in
    one package and lose it in the other.  The default, 0.1 µs, is
    below every stage's recompute, so ``cache-place`` keeps every
    cache in both."""
    import repro.caching.backends as jbackends
    import repro_torch.caching.backends as tbackends
    for mod in (jbackends, tbackends):
        monkeypatch.setattr(mod, "measure_round_trip",
                            lambda *a, **kw: seconds)
