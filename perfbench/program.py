"""The system under test: the port (``repro_torch``), built from the
benchmark's corpus and weights, and the probes the benchmark puts
around the calls into its layers.

This is the one module of the benchmark that imports the port.  It
hands the drivers the port's objects and hands the judge plain Python
(lists, dicts, floats), never the port's frames.

``Probe`` wraps methods of the port's classes for the length of a run
and restores them after.  In every run it keeps references to what the
layers return that the judge needs (BM25's rankings, the scores the
ScorerCache returns).  With ``trace=True`` it also times the calls into
each layer (``Spans``), counts pairs and tokens, and keeps the thread
and the interval of each call into a layer, so that the device trace
can tell the encoder's kernels from the rest and name what the host was
doing while the device idled (``torch.profiler`` records no range of a
thread that existed before it started, such as the service's
workers).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.caching import ScorerCache
from repro_torch.caching import compile_cache
from repro_torch.caching.bucketing import BucketedRunner
from repro_torch.caching.provenance import set_digest_device
from repro_torch.core import Experiment
from repro_torch.core.frame import ColFrame
from repro_torch.core.plan import ExecutionPlan
from repro_torch.ir import InvertedIndex, TextLoader
from repro_torch.ir.index import BM25Retriever
from repro_torch.ir.tokenizer import HashTokenizer
from repro_torch.models.cross_encoder import (DuoScorer, EncoderConfig,
                                              MonoScorer, _EncoderBase)
from repro_torch.serve import PipelineService

from .metrics.flops import call_bytes, pair_flops
from .metrics.peaks import FLOAT32_FLOPS, HBM_BYTES_PER_S

__all__ = ["Probe", "Spans", "use_device", "encoder_config", "build_index", "mono",
           "duo", "scorer_cache", "text_loader", "table2_systems",
           "experiment", "service", "compile_misses", "frame_rows",
           "ENCODER_RANGE"]

#: the span of every encoder call
ENCODER_RANGE = "encoder_call"


def use_device(device: str) -> None:
    """Provenance digests run where the scorers do: the ``cachekey_hash``
    kernel on the card, its plain version on the CPU."""
    set_digest_device("cuda" if device.startswith("cuda") else "cpu")


def encoder_config(cfg: Dict, name: str) -> EncoderConfig:
    return EncoderConfig(name=name, n_layers=cfg["num_hidden_layers"],
                         d_model=cfg["hidden_size"],
                         n_heads=cfg["num_attention_heads"],
                         d_ff=cfg["intermediate_size"],
                         vocab_size=cfg["vocab_size"],
                         max_len=cfg["max_position_embeddings"],
                         dtype=torch.float32)


def build_index(corpus) -> InvertedIndex:
    return InvertedIndex.build({"docno": d, "text": t}
                               for d, t in zip(corpus.docnos, corpus.texts))


def mono(cfg: Dict, params: Dict, device: str) -> MonoScorer:
    return MonoScorer(encoder_config(cfg, "mono"), params=params,
                      device=device)


def duo(cfg: Dict, params: Dict, device: str, max_docs: int) -> DuoScorer:
    return DuoScorer(encoder_config(cfg, "duo"), max_docs=max_docs,
                     params=params, device=device)


def scorer_cache(scorer) -> ScorerCache:
    """An empty on-disk ScorerCache in a fresh directory under TMPDIR."""
    return ScorerCache(None, scorer)


def text_loader(corpus) -> TextLoader:
    return TextLoader(corpus.text_map())


def table2_systems(index, loader, mono_stage, duo_stage, cuts) -> List:
    """Table 2's ``bm25 % k >> text_loader >> mono % 10 >> duo``."""
    bm25 = index.bm25(num_results=max(cuts))
    return [bm25 % k >> loader >> mono_stage % 10 >> duo_stage
            for k in cuts]


def experiment(systems, names, corpus, qids, queries,
               measures) -> Dict[str, Any]:
    """One ``Experiment`` with prefix precomputation over these topics.
    Returns each system's final ranking per topic and its per-topic
    measures."""
    qrels = ColFrame({
        "qid": [q for q in qids for _ in corpus.qrels[q]],
        "docno": [d for q in qids for d in corpus.qrels[q]],
        "label": [v for q in qids for v in corpus.qrels[q].values()]})
    res = Experiment(systems, ColFrame({"qid": list(qids),
                                        "query": list(queries)}),
                     qrels, measures, precompute_prefix=True, names=names,
                     keep_results=True)
    return {"rankings": [frame_rows(f) for f in res.results_frames],
            "per_query": [res.per_query[n] for n in res.names]}


def service(index, loader, scorer, depth: int, **knobs) -> PipelineService:
    """``bm25 % depth >> text_loader >> scorer`` in a PipelineService."""
    return PipelineService(index.bm25(num_results=depth) % depth >> loader
                           >> scorer, **knobs)


def compile_misses() -> int:
    return compile_cache.default_compile_cache.stats.compile_misses


def frame_rows(frame) -> Dict[str, List]:
    """qid -> [(docno, score, rank)] in rank order."""
    out: Dict[str, List] = defaultdict(list)
    if len(frame) == 0:
        return out
    rank = frame["rank"] if "rank" in frame else np.arange(len(frame))
    for q, d, s, r in zip(frame["qid"].tolist(), frame["docno"].tolist(),
                          frame["score"].tolist(), np.asarray(rank).tolist()):
        out[str(q)].append((str(d), float(s), int(r)))
    for rows in out.values():
        rows.sort(key=lambda t: t[2])
    return out


def _thread_ids() -> Tuple[int, ...]:
    """The ids a device trace may give this thread's launches: its
    native id (threads the profiler knows) and the low 32 bits of its
    pthread id, unsigned and signed (threads that existed before the
    profiler started)."""
    low = threading.get_ident() & 0xFFFFFFFF
    return threading.get_native_id(), low, low - (1 << 32)


class Spans:
    """Seconds and calls per span name, from the host's clock, counters,
    and the intervals of the layer calls the device trace is read
    against; safe across threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.counts: Dict[str, float] = defaultdict(float)
        #: (name, thread ids, start, end) of the calls into a layer
        self.intervals: List[Tuple[str, Tuple[int, ...], float, float]] = []

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.seconds[name] += seconds
            self.calls[name] += 1

    def count(self, name: str, n: float) -> None:
        with self._lock:
            self.counts[name] += n

    def interval(self, name: str, tids: Tuple[int, ...], t0: float,
                 t1: float) -> None:
        with self._lock:
            self.intervals.append((name, tids, t0, t1))


class Probe:
    """Wraps the port's layer entry points for one run."""

    def __init__(self, cfg: Dict, trace: bool):
        self.cfg = cfg
        self.trace = trace
        self.spans = Spans()
        self.recording = False
        self.bm25_out: List[Dict[str, List]] = []
        self.cache_out: List[Dict[str, List]] = []
        self._undo: List[Callable[[], None]] = []

    # -- patching ----------------------------------------------------------
    def _wrap(self, cls, name: str, make: Callable[[Callable], Callable]):
        orig = cls.__dict__[name]
        setattr(cls, name, make(orig))
        self._undo.append(lambda: setattr(cls, name, orig))

    def _timed(self, span: str, orig: Callable, *, interval: bool = False,
               after: Optional[Callable] = None) -> Callable:
        probe = self

        def wrapper(*args, **kwargs):
            if not (probe.trace and probe.recording):
                out = orig(*args, **kwargs)
            else:
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                t1 = time.perf_counter()
                probe.spans.add(span, t1 - t0)
                if interval:
                    probe.spans.interval(span, _thread_ids(), t0, t1)
            if after is not None and probe.recording:
                after(args, out)
            return out
        return wrapper

    def __enter__(self) -> "Probe":
        """Installs the wrappers.  Enter before building the scorers: a
        scorer binds its ``_score_tokens`` when it is made."""
        self._wrap(ExecutionPlan, "__init__",
                   lambda f: self._timed("plan_compile", f, interval=True))
        self._wrap(BM25Retriever, "transform", lambda f: self._timed(
            "bm25", f, interval=True, after=self._after_bm25))
        self._wrap(TextLoader, "transform",
                   lambda f: self._timed("text_loader", f, interval=True))
        self._wrap(ScorerCache, "transform", lambda f: self._timed(
            "scorer_cache", f, interval=True, after=self._after_cache))
        self._wrap(_EncoderBase, "_score_pairs",
                   lambda f: self._timed("score_pairs", f, interval=True))
        self._wrap(_EncoderBase, "_score_tokens",
                   lambda f: self._timed(ENCODER_RANGE, f, interval=True,
                                         after=self._after_tokens))
        self._wrap(HashTokenizer, "encode_pair",
                   lambda f: self._timed("tokenize", f))
        self._wrap(BucketedRunner, "__call__", lambda f: self._timed(
            "bucketed_runner", f, after=self._after_runner))
        return self

    def __exit__(self, *exc) -> None:
        while self._undo:
            self._undo.pop()()

    # -- what the layers returned -----------------------------------------
    def _after_bm25(self, args, out) -> None:
        self.bm25_out.append(frame_rows(out))
        if self.trace:
            self.spans.count("bm25_topics", len(args[1]))

    def _after_cache(self, args, out) -> None:
        self.cache_out.append(frame_rows(out))

    def _after_tokens(self, args, out) -> None:
        if self.trace:
            tokens = args[1]
            self.spans.count("tokens_computed", tokens.size)

    def _after_runner(self, args, out) -> None:
        if not self.trace:
            return
        runner, toks = args[0], args[1]
        if toks.ndim != 2 or len(toks) == 0:
            return
        lengths = np.count_nonzero(toks, axis=1)
        sp = self.spans
        sp.count("tokens_useful", float(lengths.sum()))
        for lo in range(0, len(lengths), runner.max_bucket):
            chunk = lengths[lo:lo + runner.max_bucket]   # one encoder call
            flops = float(pair_flops(self.cfg, chunk).sum())
            sp.count("encoder_flops", flops)
            sp.count("encoder_least_s", max(
                flops / FLOAT32_FLOPS,
                call_bytes(self.cfg, chunk) / HBM_BYTES_PER_S))
