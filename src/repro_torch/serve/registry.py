"""Named serving scenarios for ``repro_torch.cli serve``.

Counterpart of ``repro.serve.registry``: the same scenarios, corpora,
topics, seeds and encoder configs.  A *scenario* bundles a pipeline
expression with the synthetic corpus / topic set it runs against, so
the CLI, the launcher and ``chip_smoke.py`` stand up the same
workloads by name:

* ``"bm25"``       — first-stage retrieval only (``bm25 % cutoff``);
* ``"bm25-mono"``  — the paper's §4.2 two-stage composition
  (``bm25 % cutoff >> text_loader >> mono_scorer``);
* ``"mono"``       — the bare pointwise scorer (requests carry their
  own text);
* ``"dense"``      — neural first-stage retrieval over the hand-written
  ``dense_topk`` kernel (``dense % cutoff``, cutoff fused into the
  kernel's per-block k by the optimizer);
* ``"hybrid"``     — sparse+dense candidate union reranked by the mono
  scorer (``(bm25 % cutoff | dense % cutoff) >> text_loader >> mono``);
* ``"bm25-sim"``   — bm25 retrieval followed by a fixed per-row
  simulated device latency (``cacheable=False``, so it always
  executes): a GIL-releasing stand-in for an accelerator-bound
  reranker, which is what makes fleet throughput scaling measurable
  on any host (sleeps overlap across worker processes even on one
  core).

The encoders and the dense index live on ``device`` (CUDA unless the
caller passes ``"cpu"``; :func:`repro_torch.device.resolve_device`).
``params`` bridges weights in: ``{"mono": tree, "dense": tree}`` of
numpy arrays, for instance the reference's ``init_params``; without it
each encoder draws its weights from ``torch.Generator`` with the
reference's seed.

``run_closed_loop`` is the shared traffic generator: N closed-loop
client threads, each submitting one query at a time and waiting for its
result — the canonical serving-latency measurement loop.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.frame import ColFrame
from ..core.pipeline import Transformer
from ..device import resolve_device

__all__ = ["ServeScenario", "SERVE_PIPELINES", "SimulatedLatency",
           "build_scenario", "run_closed_loop", "warming_frame"]


@dataclass
class ServeScenario:
    """A servable pipeline plus the topics that generate its traffic."""
    name: str
    pipeline: Transformer
    topics: ColFrame                     # Q(qid, query) request pool
    description: str = ""
    #: extra per-request row columns keyed by qid (e.g. doc text for
    #: scorer-only scenarios); empty for whole-pipeline serving
    request_extra: Dict[str, Dict[str, Any]] = field(default_factory=dict)


def _encoder(device, params: Dict[str, Any]):
    from ..models.cross_encoder import EncoderConfig, MonoScorer
    return MonoScorer(EncoderConfig(n_layers=2, d_model=64, n_heads=4,
                                    d_ff=128, vocab_size=8192, max_len=32),
                      params=params.get("mono"), device=device)


def _build_bm25(*, scale: float, cutoff: int, num_results: int,
                seed: int, device, params) -> ServeScenario:
    from ..ir import InvertedIndex, msmarco_like
    corpus = msmarco_like(1, scale=scale, seed=seed)
    index = InvertedIndex.build(corpus.get_corpus_iter())
    return ServeScenario(
        name="bm25",
        pipeline=index.bm25(num_results=num_results) % cutoff,
        topics=corpus.get_topics(),
        description=f"BM25 retrieval, top-{cutoff} "
                    f"(num_results={num_results}, pushdown fuses the cutoff)")


def _build_bm25_mono(*, scale: float, cutoff: int, num_results: int,
                     seed: int, device, params) -> ServeScenario:
    from ..ir import InvertedIndex, TextLoader, msmarco_like
    corpus = msmarco_like(1, scale=scale, seed=seed)
    index = InvertedIndex.build(corpus.get_corpus_iter())
    pipeline = (index.bm25(num_results=num_results) % cutoff
                >> TextLoader(corpus.text_map()) >> _encoder(device, params))
    return ServeScenario(
        name="bm25-mono",
        pipeline=pipeline,
        topics=corpus.get_topics(),
        description=f"two-stage retrieve-and-rerank: bm25 % {cutoff} "
                    f">> text_loader >> mono scorer")


def _build_mono(*, scale: float, cutoff: int, num_results: int,
                seed: int, device, params) -> ServeScenario:
    from ..ir import msmarco_like
    corpus = msmarco_like(1, scale=scale, seed=seed)
    docs = corpus.docs
    rng = np.random.default_rng(seed)
    topics = corpus.get_topics()
    extra: Dict[str, Dict[str, Any]] = {}
    n = min(len(docs), 200)
    for qid in topics["qid"].tolist():
        d = int(rng.integers(0, n))
        extra[str(qid)] = {"docno": str(docs["docno"][d]),
                           "text": str(docs["text"][d])}
    return ServeScenario(
        name="mono",
        pipeline=_encoder(device, params),
        topics=topics,
        description="bare pointwise scorer (requests carry doc text)",
        request_extra=extra)


def _dense_retriever(corpus, *, num_results: int, seed: int, device,
                     params):
    from ..ir.dense import DenseEncoder, DenseIndex
    from ..models.cross_encoder import EncoderConfig
    cfg = EncoderConfig(name="dense-serve", n_layers=1, d_model=32,
                        n_heads=2, d_ff=64, vocab_size=2048, max_len=16)
    index = DenseIndex(DenseEncoder(cfg, seed=seed + 7,
                                    params=params.get("dense"),
                                    device=device)).index(
        corpus.get_corpus_iter())
    return index.retriever(num_results=num_results)


def _build_dense(*, scale: float, cutoff: int, num_results: int,
                 seed: int, device, params) -> ServeScenario:
    from ..ir import msmarco_like
    corpus = msmarco_like(1, scale=scale, seed=seed)
    dense = _dense_retriever(corpus, num_results=num_results, seed=seed,
                             device=device, params=params)
    return ServeScenario(
        name="dense",
        pipeline=dense % cutoff,
        topics=corpus.get_topics(),
        description=f"dense retrieval over the fused dense_topk stage, "
                    f"top-{cutoff} (num_results={num_results}, pushdown "
                    f"fuses the cutoff into the kernel's per-block k)")


def _build_hybrid(*, scale: float, cutoff: int, num_results: int,
                  seed: int, device, params) -> ServeScenario:
    from ..ir import InvertedIndex, TextLoader, msmarco_like
    corpus = msmarco_like(1, scale=scale, seed=seed)
    index = InvertedIndex.build(corpus.get_corpus_iter())
    dense = _dense_retriever(corpus, num_results=num_results, seed=seed,
                             device=device, params=params)
    pipeline = ((index.bm25(num_results=num_results) % cutoff
                 | dense % cutoff)
                >> TextLoader(corpus.text_map()) >> _encoder(device, params))
    return ServeScenario(
        name="hybrid",
        pipeline=pipeline,
        topics=corpus.get_topics(),
        description=f"sparse+dense candidate union reranked by the mono "
                    f"scorer: (bm25 % {cutoff} | dense % {cutoff}) "
                    f">> text_loader >> mono")


class SimulatedLatency(Transformer):
    """Identity stage that sleeps ``per_row_ms`` per input row.

    Models an accelerator-bound stage whose cost is proportional to the
    candidate set (a cross-encoder scoring pass): ``time.sleep``
    releases the GIL exactly like a device dispatch, so N worker
    *processes* overlap N requests' latencies even on a single CPU
    core.  ``cacheable=False`` keeps the planner from memoizing it —
    the work must happen on every request, warm cache or not, or the
    fleet benchmark would measure cache lookups instead of serving
    capacity.  ``augment_only`` stays False for the same reason: the
    cache-prune pass may defer exclusive augment-only chains behind
    warm stores, which would skip the simulated work on hits.
    """

    cacheable = False
    rank_preserving = True

    def __init__(self, per_row_ms: float = 2.0):
        self.per_row_ms = float(per_row_ms)

    def transform(self, inp: ColFrame) -> ColFrame:
        time.sleep(self.per_row_ms * 1e-3 * max(1, len(inp)))
        return inp

    def signature(self):
        return ("SimulatedLatency", self.per_row_ms)


def _build_bm25_sim(*, scale: float, cutoff: int, num_results: int,
                    seed: int, device, params) -> ServeScenario:
    from ..ir import InvertedIndex, msmarco_like
    corpus = msmarco_like(1, scale=scale, seed=seed)
    index = InvertedIndex.build(corpus.get_corpus_iter())
    pipeline = (index.bm25(num_results=num_results) % cutoff
                >> SimulatedLatency())
    return ServeScenario(
        name="bm25-sim",
        pipeline=pipeline,
        topics=corpus.get_topics(),
        description=f"bm25 % {cutoff} >> simulated per-row device latency "
                    f"(uncacheable; the fleet-scaling workload)")


SERVE_PIPELINES: Dict[str, Callable[..., ServeScenario]] = {
    "bm25": _build_bm25,
    "bm25-mono": _build_bm25_mono,
    "mono": _build_mono,
    "dense": _build_dense,
    "hybrid": _build_hybrid,
    "bm25-sim": _build_bm25_sim,
}


def build_scenario(name: str, *, scale: float = 0.05, cutoff: int = 10,
                   num_results: int = 100, seed: int = 0,
                   device: Any = None,
                   params: Optional[Dict[str, Any]] = None) -> ServeScenario:
    """Construct a named serving scenario (see ``SERVE_PIPELINES``) with
    its encoders and dense index on ``device`` (CUDA by default; raises
    without a CUDA device unless ``device="cpu"``)."""
    try:
        make = SERVE_PIPELINES[name]
    except KeyError:
        raise KeyError(f"unknown serving pipeline {name!r}; known: "
                       f"{sorted(SERVE_PIPELINES)}") from None
    return make(scale=scale, cutoff=cutoff, num_results=num_results,
                seed=seed, device=resolve_device(device),
                params=dict(params or {}))


def warming_frame(scenario: ServeScenario, *,
                  budget: Optional[int] = None,
                  n_requests: int = 512, n_clients: int = 4,
                  seed: int = 0) -> ColFrame:
    """The scenario's expected traffic as a query frame for offline
    cache warming (``warm_scenario`` / ``ExecutionPlan.warm``).

    Simulates the *exact* per-client zipf draws of ``run_closed_loop``
    (same rng seeding, same index formula) to rank topics by expected
    request frequency, then appends the never-drawn tail in topic
    order — so ``budget=None`` covers the whole pool (a subsequent
    serve epoch with matching ``seed``/``scale`` has zero misses) and
    ``budget=N`` precomputes the N most valuable queries first.
    Request-extra columns (e.g. the doc text of scorer-only scenarios)
    are merged per qid, mirroring what ``run_closed_loop`` submits.
    """
    qids = [str(q) for q in scenario.topics["qid"].tolist()]
    queries = scenario.topics["query"].tolist()
    n_topics = len(qids)
    counts = np.zeros(n_topics, dtype=np.int64)
    n_clients = max(1, n_clients)
    per_client = [n_requests // n_clients
                  + (1 if c < n_requests % n_clients else 0)
                  for c in range(n_clients)]
    for cid in range(n_clients):
        rng = np.random.default_rng(seed * 1009 + cid)
        for _ in range(per_client[cid]):
            i = int(min(rng.zipf(1.3) - 1, n_topics - 1))
            counts[i] += 1
    # hottest first; zero-count tail keeps topic order (stable sort on
    # -count), so the full-pool warm is deterministic
    order = np.argsort(-counts, kind="stable")
    if budget is not None:
        order = order[:max(0, int(budget))]
    rows: List[Dict[str, Any]] = []
    for i in order.tolist():
        row = {"qid": qids[i], "query": queries[i]}
        row.update(scenario.request_extra.get(qids[i], {}))
        rows.append(row)
    return ColFrame.from_dicts(rows)


def run_closed_loop(service, scenario: ServeScenario, *,
                    n_requests: int, n_clients: int = 4,
                    seed: int = 0,
                    timeout: Optional[float] = 120.0) -> Dict[str, float]:
    """Closed-loop request stream: ``n_clients`` threads each submit
    one query at a time (drawn from the scenario's topic pool with a
    skew toward popular queries) and wait for the result before
    submitting the next — so concurrency equals the client count and
    the service's micro-batching does the coalescing.

    Returns wall-clock throughput and request counts; latency
    percentiles live in ``service.stats``.
    """
    qids = scenario.topics["qid"].tolist()
    queries = scenario.topics["query"].tolist()
    n_topics = len(qids)
    n_clients = max(1, n_clients)
    # distribute the remainder so exactly n_requests are issued
    per_client = [n_requests // n_clients
                  + (1 if c < n_requests % n_clients else 0)
                  for c in range(n_clients)]
    errors: List[BaseException] = []
    done = [0]
    lock = threading.Lock()

    def client(cid: int) -> None:
        rng = np.random.default_rng(seed * 1009 + cid)
        for _ in range(per_client[cid]):
            # zipf-ish skew: repeat traffic is what caching pays for
            i = int(min(rng.zipf(1.3) - 1, n_topics - 1))
            qid = str(qids[i])
            extra = scenario.request_extra.get(qid, {})
            try:
                fut = service.submit(qid, queries[i], **extra)
                fut.result(timeout)
                with lock:
                    done[0] += 1
            except BaseException as e:   # surface, don't hang the loop
                with lock:
                    errors.append(e)
                return

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return {"requests": done[0], "clients": n_clients,
            "wall_s": round(wall_s, 4),
            "throughput_rps": round(done[0] / wall_s, 2) if wall_s else 0.0}
