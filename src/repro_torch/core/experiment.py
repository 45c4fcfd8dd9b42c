"""Declarative experiments (paper §2.2).

Counterpart of ``repro.core.experiment``.  ``Experiment(systems, topics,
qrels, measures, ...)`` invokes each system on the topics, evaluates
with the requested measures, and (optionally) runs paired significance
tests against a baseline with multiple-testing correction (Fuhr / Sakai
guidance cited by the paper).

Prefix precomputation (§3) needs the plan compiler, which this package
ports in a later slice: ``precompute_prefix=True`` with more than one
system raises rather than run the systems without sharing.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .frame import ColFrame
from .measures import evaluate, parse_measure
from .pipeline import Transformer

__all__ = ["Experiment", "ExperimentResult"]


# ---------------------------------------------------------------------------
# significance machinery
# ---------------------------------------------------------------------------

def _paired_ttest(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sided paired t-test p-value (scipy if present, else exact
    incomplete-beta evaluation of the t CDF)."""
    d = np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)
    n = d.size
    if n < 2:
        return 1.0
    sd = d.std(ddof=1)
    if sd == 0:
        return 1.0
    t = d.mean() / (sd / math.sqrt(n))
    df = n - 1
    try:
        from scipy import stats  # type: ignore
        return float(stats.t.sf(abs(t), df) * 2.0)
    except Exception:
        x = df / (df + t * t)
        return float(_betainc(df / 2.0, 0.5, x))


def _betainc(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a,b) via continued fraction."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    lbeta = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    front = math.exp(math.log(x) * a + math.log1p(-x) * b - lbeta) / a
    # Lentz's continued fraction
    f, c, d = 1.0, 1.0, 0.0
    for i in range(200):
        m = i // 2
        if i == 0:
            num = 1.0
        elif i % 2 == 0:
            num = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
        else:
            num = -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
        d = 1.0 + num * d
        d = 1.0 / (d if abs(d) > 1e-30 else 1e-30)
        c = 1.0 + num / (c if abs(c) > 1e-30 else 1e-30)
        f *= c * d
        if abs(1.0 - c * d) < 1e-12:
            break
    val = front * (f - 1.0)
    if x < (a + 1.0) / (a + b + 2.0):
        return min(max(val, 0.0), 1.0)
    return min(max(1.0 - val, 0.0), 1.0)


def _correct(pvals: List[float], method: str) -> List[float]:
    p = np.asarray(pvals, dtype=np.float64)
    m = p.size
    if m == 0:
        return []
    if method in ("bonferroni", "bonf"):
        return list(np.minimum(p * m, 1.0))
    if method in ("holm", "holm-bonferroni"):
        order = np.argsort(p)
        adj = np.empty(m)
        running = 0.0
        for rank, idx in enumerate(order):
            running = max(running, (m - rank) * p[idx])
            adj[idx] = min(running, 1.0)
        return list(adj)
    if method in ("none", None):
        return list(p)
    raise ValueError(f"unknown correction {method!r}")


# ---------------------------------------------------------------------------

@dataclass
class ExperimentResult:
    """Tabular result of an Experiment."""
    names: List[str]
    measures: List[str]
    means: Dict[str, Dict[str, float]]               # name -> measure -> mean
    per_query: Dict[str, Dict[str, Dict[str, float]]]  # name -> measure -> qid -> v
    pvalues: Dict[str, Dict[str, float]] = field(default_factory=dict)
    corrected_pvalues: Dict[str, Dict[str, float]] = field(default_factory=dict)
    times_s: Dict[str, float] = field(default_factory=dict)
    total_time_s: float = 0.0
    results_frames: Optional[List[ColFrame]] = None

    def row(self, name: str) -> Dict[str, float]:
        return dict(self.means[name])

    def to_rows(self) -> List[Dict[str, Any]]:
        rows = []
        for n in self.names:
            r: Dict[str, Any] = {"name": n}
            r.update(self.means[n])
            if n in self.pvalues:
                for m, p in self.pvalues[n].items():
                    r[f"p({m})"] = p
            rows.append(r)
        return rows

    def __str__(self) -> str:
        cols = ["name"] + self.measures
        widths = {c: max(len(c), 12) for c in cols}
        lines = ["  ".join(c.ljust(widths[c]) for c in cols)]
        for n in self.names:
            vals = [n.ljust(widths["name"])]
            for m in self.measures:
                vals.append(f"{self.means[n][m]:.4f}".ljust(widths[m]))
            lines.append("  ".join(vals))
        return "\n".join(lines)


def Experiment(
    systems: Sequence[Transformer],
    topics: Any,
    qrels: Any,
    measures: Sequence,
    *,
    names: Optional[Sequence[str]] = None,
    precompute_prefix: bool = False,
    baseline: Optional[int] = None,
    correction: str = "holm",
    batch_size: Optional[int] = None,
    keep_results: bool = False,
    verbose: bool = False,
) -> ExperimentResult:
    """Evaluate ``systems`` on ``topics`` against ``qrels``.

    Mirrors the paper's ``pt.Experiment`` signature: systems, topics
    (type Q), qrels (type RA), measures; plus significance testing wrt.
    ``baseline`` with multiple-testing ``correction`` (Fuhr/Sakai), and
    ``batch_size``.  Each system runs on the topics on its own (the
    paper's Table 2 setting (1)).  ``precompute_prefix=True`` with more
    than one system raises ``NotImplementedError``.
    """
    topics = ColFrame.coerce(topics)
    qrels = ColFrame.coerce(qrels)
    measures = [parse_measure(m) for m in measures]
    systems = list(systems)
    if names is None:
        names = [repr(s) for s in systems]
    names = [str(n) for n in names]
    if len(names) != len(systems):
        raise ValueError("names must align with systems")
    if precompute_prefix and len(systems) > 1:
        raise NotImplementedError(
            "precompute_prefix=True needs the plan compiler (prefix "
            "sharing across systems), which arrives with the "
            "plan-compiler slice of repro_torch")

    t0 = time.perf_counter()
    times: Dict[str, float] = {}
    outs = []
    for s, n in zip(systems, names):
        ts = time.perf_counter()
        if batch_size is None or len(topics) <= batch_size:
            outs.append(s(topics))
        else:
            parts = [s(topics.take(range(lo, min(lo + batch_size,
                                                 len(topics)))))
                     for lo in range(0, len(topics), batch_size)]
            outs.append(ColFrame.concat(parts))
        times[n] = time.perf_counter() - ts
        if verbose:
            print(f"[experiment] {n}: {times[n]:.3f}s")

    per_query: Dict[str, Dict[str, Dict[str, float]]] = {}
    means: Dict[str, Dict[str, float]] = {}
    for n, res in zip(names, outs):
        pq = evaluate(res, qrels, measures)
        per_query[n] = pq
        means[n] = {m.name: (float(np.mean(list(pq[m.name].values())))
                             if pq[m.name] else 0.0)
                    for m in measures}

    result = ExperimentResult(
        names=names, measures=[m.name for m in measures], means=means,
        per_query=per_query, times_s=times,
        total_time_s=time.perf_counter() - t0,
        results_frames=list(outs) if keep_results else None)

    if baseline is not None:
        base_name = names[baseline]
        raw_all: List[Tuple[str, str, float]] = []
        for n in names:
            if n == base_name:
                continue
            result.pvalues[n] = {}
            for m in result.measures:
                qids = sorted(per_query[base_name][m])
                a = np.array([per_query[n][m].get(q, 0.0) for q in qids])
                b = np.array([per_query[base_name][m][q] for q in qids])
                p = _paired_ttest(a, b)
                result.pvalues[n][m] = p
                raw_all.append((n, m, p))
        corrected = _correct([p for _, _, p in raw_all], correction)
        for (n, m, _), cp in zip(raw_all, corrected):
            result.corrected_pvalues.setdefault(n, {})[m] = cp
    return result
