"""Driver ``open_loop``: requests sent on a schedule, whatever the service
has finished.

Arrivals are Poisson at ``rate_per_s``: one sample path, drawn from the
mix's ``arrival_seed``, the same for every run, so that a run's tail
reflects the system and not the burst its seed drew (with the gaps
drawn per seed, the 95th percentile of six seeds ranged over a factor
of two while two runs of one seed agreed within 4 %).  The run's seed
gives the corpus, the weights and which queries arrive, drawn without
replacement from a pool of generated topics, so none repeats.  A request's latency
runs from when it was due to when its result came back; a request that
fails, or does not come back within ``drain_s`` after the window,
counts as missing, with the latency of the whole wait for it.

Set-up builds the corpus, the weights, the index and the scorer inside a
``PipelineService`` and warms each batch shape the traffic can make by
serving frames of ``warm_batches`` queries kept out of the window,
largest first, handing the allocator's free blocks back after each.
At each row bucket those frames issued it then captures every sequence
bucket a call there can reach (``program.warm_shapes``), so that no
graph is captured inside the window (``compiles_in_window``).
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Dict

import numpy as np
import torch

from .. import program
from ..judge import Judge
from ..weights import draw, to_numpy
from .corpus import make_corpus


def schedule(traffic: Dict, seconds: float) -> np.ndarray:
    """Due times (seconds from the window's start) inside the window:
    one Poisson sample path, the same for every run."""
    rate = traffic["rate_per_s"]
    n = int(rate * seconds * 2) + 64
    gaps = np.random.default_rng(traffic["arrival_seed"]).exponential(
        1.0 / rate, size=n)
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return due[due < seconds]


def setup(run) -> Dict:
    p, cfg = run.traffic, run.config
    warm = sum(p["warm_batches"])
    corpus = make_corpus(cfg["corpus_name"], n_docs=cfg["corpus_passages"],
                         n_topics=p["topic_pool"] + warm, seed=run.seed,
                         **cfg["corpus_shape"])
    gen = torch.Generator(run.device).manual_seed(run.seed)
    weights = {"mono": draw(cfg, gen)}
    index = program.build_index(corpus)
    mono = program.mono(cfg, to_numpy(weights["mono"]), run.device)
    svc = program.service(index, program.text_loader(corpus), mono,
                          p["depth"], **p["service"])
    at = p["topic_pool"]
    for n in sorted(p["warm_batches"], reverse=True):
        svc.search({"qid": corpus.qids[at:at + n],
                    "query": corpus.queries[at:at + n]})
        at += n
        if run.device.startswith("cuda"):
            # each CUDA-graph capture warms up on a stream of its own,
            # whose freed blocks no later stream reuses: hand them back
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shapes = program.warm_shapes(mono, program.rows_issued(mono),
                                 corpus.queries, corpus.texts)
    print(f"[open_loop] warmed (rows, columns) {shapes} in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    order = np.random.default_rng([run.seed, 1]).permutation(p["topic_pool"])
    return dict(corpus=corpus, weights=weights, service=svc, order=order,
                mono=mono)


def window(run, st: Dict, seconds: float) -> Dict:
    corpus, svc = st["corpus"], st["service"]
    due = schedule(run.traffic, seconds)
    if len(due) > len(st["order"]):
        raise RuntimeError("the topic pool is smaller than the schedule")
    n = len(due)
    sent = np.full(n, np.nan)
    back = np.full(n, np.nan)
    futs = []
    compiles0 = program.compile_misses()
    stats0 = (svc.stats.requests, svc.stats.batches)
    pairs0 = st["mono"].invocations
    t0 = time.perf_counter()
    for i, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        q = int(st["order"][i])
        sent[i] = time.perf_counter() - t0
        fut = svc.submit(corpus.qids[q], corpus.queries[q])
        fut.add_done_callback(
            lambda f, i=i: back.__setitem__(i, time.perf_counter() - t0))
        futs.append((q, fut))
    close = t0 + seconds
    left = threading.Event()
    while True:
        pending = [f for _, f in futs if not f.done()]
        if not pending or time.perf_counter() > close \
                + run.traffic["drain_s"]:
            break
        left.wait(0.01)
    gave_up = time.perf_counter() - t0
    results, failed = [], 0
    for i, (q, f) in enumerate(futs):
        if not f.done() or f.exception() is not None:
            failed += 1              # missing: as late as the wait for it
            back[i] = max(gave_up, back[i]) if f.done() else gave_up
            results.append(None)
        else:
            results.append((q, program.frame_rows(f.result())))
    lat_ms = (back - due) * 1e3
    late = sent - due
    half = n // 2
    print(f"[open_loop] sent {n} in {seconds} s at "
          f"{run.traffic['rate_per_s']}/s; latest send "
          f"{np.nanmax(late) * 1e3:.3f} ms late; p50 first half "
          f"{np.median(lat_ms[:half]):.3f} ms, second half "
          f"{np.median(lat_ms[half:]):.3f} ms; failed {failed}",
          file=sys.stderr)
    return {"window_s": float(seconds), "latencies_ms": lat_ms,
            "results": results, "attempted": n, "failed": failed,
            "counters": {"requests": svc.stats.requests - stats0[0],
                         "batches": svc.stats.batches - stats0[1],
                         "pairs_encoded": st["mono"].invocations - pairs0,
                         "plan_cache_hits": svc.plan_stats().cache_hits,
                         "compiles_in_window":
                             program.compile_misses() - compiles0}}


def close(st: Dict) -> None:
    st.pop("service").close()
    st.pop("mono")


def judge(run, st: Dict, rec: Dict) -> Dict[str, float]:
    corpus = st["corpus"]
    done = [r for r in rec["results"] if r is not None]
    rng = np.random.default_rng([run.seed, 2])
    pick = rng.choice(len(done), size=min(run.traffic["check_requests"],
                                          len(done)), replace=False)
    sample = []
    for j in sorted(pick.tolist()):
        q, rows = done[j]
        qid = corpus.qids[q]
        sample.append({"qid": qid, "query": corpus.queries[q],
                       "rows": rows.get(qid, [])})
    j = Judge(corpus, run.config, st["weights"], run.limits)
    return j.serving(sample, run.traffic["depth"], run.probe.bm25_out,
                     rec["failed"])
