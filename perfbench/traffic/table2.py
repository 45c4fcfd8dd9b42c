"""Driver ``table2``: a closed loop of Table 2 Experiments.

Each Experiment runs ``[bm25 % k >> text_loader >> cache % 10 >> duo for
k in cuts]`` with prefix precomputation over a fresh batch of topics from
the pool, in the order the seed gives, and evaluates nDCG@10 and MAP.
The ScorerCache starts empty in the window and holds only what the
window wrote, so each topic's Mono pairs miss once and hit in the later
systems.  Experiments run back to back; the one running when the window
closes finishes and counts, and so does its time.

Set-up builds the corpus, the weights, the index and both scorers, and
warms every shape the window uses by one Experiment over topics kept
out of the window, through a ScorerCache of its own that it then drops.
At each row bucket that Experiment issued, each scorer then captures
every sequence bucket a call there can reach
(``program.warm_shapes``, through the scorers and not the cache), so
that no graph is captured inside the window (``compiles_in_window``).
"""
from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from .. import program
from ..judge import Judge
from ..weights import draw, to_numpy
from .corpus import make_corpus

MEASURES = ["nDCG@10", "MAP"]


def setup(run) -> Dict:
    p, cfg = run.traffic, run.config
    per, pool = p["topics_per_experiment"], p["topic_pool"]
    corpus = make_corpus(cfg["corpus_name"], n_docs=cfg["corpus_passages"],
                         n_topics=pool + per, seed=run.seed,
                         **cfg["corpus_shape"])
    gen = torch.Generator(run.device).manual_seed(run.seed)
    weights = {"mono": draw(cfg, gen), "duo": draw(cfg, gen)}
    index = program.build_index(corpus)
    loader = program.text_loader(corpus)
    mono = program.mono(cfg, to_numpy(weights["mono"]), run.device)
    duo = program.duo(cfg, to_numpy(weights["duo"]), run.device,
                      p["duo_docs"])
    names = [f"k={k}" for k in p["cuts"]]

    warm_cache = program.scorer_cache(mono)
    warm = list(range(pool, pool + per))
    program.experiment(
        program.table2_systems(index, loader, warm_cache, duo, p["cuts"]),
        names, corpus, [corpus.qids[i] for i in warm],
        [corpus.queries[i] for i in warm], MEASURES)
    warm_cache.close()
    t0 = time.perf_counter()
    shapes = [program.warm_shapes(scorer, program.rows_issued(scorer),
                                  corpus.queries, corpus.texts)
              for scorer in (mono, duo)]
    print(f"[table2] warmed (rows, columns) of Mono {shapes[0]} and Duo "
          f"{shapes[1]} in {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)

    cache = program.scorer_cache(mono)
    order = np.random.default_rng([run.seed, 1]).permutation(pool)
    return dict(corpus=corpus, weights=weights, mono=mono, duo=duo,
                cache=cache, names=names, order=order,
                systems=program.table2_systems(index, loader, cache, duo,
                                               p["cuts"]))


def window(run, st: Dict, seconds: float) -> Dict:
    per = run.traffic["topics_per_experiment"]
    corpus = st["corpus"]
    mono0, duo0 = st["mono"].invocations, st["duo"].invocations
    compiles0 = program.compile_misses()
    done = []
    t0 = time.perf_counter()
    while True:
        lo = len(done) * per
        if lo + per > len(st["order"]):
            raise RuntimeError("the topic pool ran out inside the window")
        idx = st["order"][lo:lo + per]
        qids = [corpus.qids[i] for i in idx]
        queries = [corpus.queries[i] for i in idx]
        out = program.experiment(st["systems"], st["names"], corpus, qids,
                                 queries, MEASURES)
        done.append((qids, queries, out))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    stats = st["cache"].stats
    return {"window_s": window_s, "experiments": done,
            "attempted": len(done) * per, "failed": 0,
            "counters": {"topics": len(done) * per,
                         "experiments": len(done),
                         "mono_pairs": st["mono"].invocations - mono0,
                         "duo_pairs": st["duo"].invocations - duo0,
                         "pairs_encoded": st["mono"].invocations - mono0
                         + st["duo"].invocations - duo0,
                         "cache_hits": stats.hits,
                         "cache_misses": stats.misses,
                         "compiles_in_window":
                             program.compile_misses() - compiles0}}


def close(st: Dict) -> None:
    st["cache"].close()
    for key in ("mono", "duo", "systems", "cache"):
        st.pop(key, None)


def judge(run, st: Dict, rec: Dict) -> Dict[str, float]:
    topics = [(e, i) for e, (qids, _, _) in enumerate(rec["experiments"])
              for i in range(len(qids))]
    rng = np.random.default_rng([run.seed, 2])
    pick = rng.choice(len(topics), size=min(run.traffic["check_topics"],
                                            len(topics)), replace=False)
    sample = []
    for j in sorted(pick.tolist()):
        e, i = topics[j]
        qids, queries, out = rec["experiments"][e]
        q = qids[i]
        sample.append({
            "qid": q, "query": queries[i],
            "final": [r.get(q, []) for r in out["rankings"]],
            "measures": [{m: pq[m][q] for m in MEASURES}
                         for pq in out["per_query"]]})
    j = Judge(st["corpus"], run.config, st["weights"], run.limits)
    return j.experiment(sample, run.traffic["cuts"], run.probe.bm25_out,
                        run.probe.cache_out)
