"""The port's span recorder (``repro_torch.core.trace``): off it hands out
one shared no-op and reads no clock; on it keeps nested spans with their
parents, threads and request ids, is safe from a thread pool and drops
past its capacity; its spans land on a ``torch.profiler`` export's clock;
a served request's spans share its id inside its ``serve.request``; a
plan records its compile time; and the tokeniser's span counts every
pair the scorers score."""
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import repro_torch.core as tcore
import repro_torch.ir as tir
from repro_torch.caching.provenance import set_digest_device
from repro_torch.core import trace
from repro_torch.models import cross_encoder as tce
from repro_torch.serve import PipelineService

torch.set_num_threads(1)
set_digest_device("cpu")

SMALL = dict(n_layers=1, d_model=16, n_heads=2, d_ff=32, vocab_size=512,
             max_len=16)


@pytest.fixture
def recording():
    """The process recorder, on for one test and off after it."""
    assert trace.active() is None
    rec = trace.enable()
    try:
        yield rec
    finally:
        if trace.active() is not None:
            trace.disable()


@pytest.fixture(scope="module")
def toy():
    corpus = tir.msmarco_like(1, scale=0.02)
    index = tir.InvertedIndex.build(corpus.get_corpus_iter())
    return corpus, index, tir.TextLoader(corpus.text_map())


def _inside(inner, outer) -> bool:
    return outer.t0 <= inner.t0 and inner.t1 <= outer.t1


class _NoClock:
    """Stands in for the ``time`` module: any clock read fails."""

    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read while recording is off")


def test_off_is_one_noop_reading_no_clock(monkeypatch):
    assert trace.active() is None
    monkeypatch.setattr(trace, "time", _NoClock())
    a, b = trace.span("encoder.tokenize", pairs=3), trace.span("x")
    assert a is b is trace.NOOP
    with trace.span("bm25.retrieve", topics=1) as s:
        assert s is trace.NOOP
    trace.count("encoder.tokens_useful", 7)
    trace.add("serve.queue", 1, 2, req=1)
    assert trace.now_ns() == 0
    assert trace.node_span(None, "n", 0) is trace.NOOP
    assert trace.disable() is None


def test_nested_spans_parents_threads_and_requests(recording):
    with trace.span("serve.finalize", req=(4, 5)):
        with trace.span("encoder.call", rows=8):
            with trace.span("encoder.sync"):
                pass
        trace.add("serve.request", 10, 20, req=4)
    trace.count("encoder.tokens_useful", 3)
    trace.count("encoder.tokens_useful", 4)
    rec = trace.disable()
    by = {s.name: s for s in rec.spans}
    fin, call, sync = by["serve.finalize"], by["encoder.call"], \
        by["encoder.sync"]
    assert fin.parent == 0 and call.parent == fin.id \
        and sync.parent == call.id
    assert call.req == sync.req == (4, 5) and call.requests == (4, 5)
    assert by["serve.request"].parent == fin.id \
        and by["serve.request"].req == 4
    assert call.attrs == {"rows": 8} and sync.attrs is None
    assert _inside(sync, call) and _inside(call, fin)
    assert call.tid == threading.get_native_id()
    assert call.pthread == threading.get_ident() & 0xFFFFFFFF
    assert rec.counters == {"encoder.tokens_useful": 7}
    assert len({s.id for s in rec.spans}) == 4 and rec.dropped == 0


def test_safe_from_a_thread_pool(recording):
    workers, each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(each):
                with trace.span("plan.node", req=k):
                    with trace.span("encoder.call", i=i):
                        trace.count("calls")
            return threading.get_native_id()
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(work, range(workers), timeout=120))
    finally:
        sys.setswitchinterval(old)
    rec = trace.disable()
    assert len(rec.spans) == 2 * workers * each and rec.dropped == 0
    assert rec.counters == {"calls": workers * each}
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    outer = {s.id: s for s in rec.spans if s.name == "plan.node"}
    for s in rec.spans:
        if s.name == "encoder.call":
            p = outer[s.parent]
            assert p.tid == s.tid and p.req == s.req and _inside(s, p)


def test_capacity_drops_and_counts(recording):
    trace.disable()
    rec = trace.enable(capacity=10)
    for _ in range(25):
        with trace.span("x"):
            pass
    late = trace.span("open at disable")
    late.__enter__()
    assert trace.disable() is rec
    late.__exit__(None, None, None)
    assert len(rec.spans) == 10 and rec.dropped == 16
    with pytest.raises(RuntimeError):
        trace.enable()
        trace.enable()


def test_spans_contain_a_profiler_range_on_its_clock(recording, tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("outer"):
            time.sleep(0.002)
            with torch.profiler.record_function("inner_range"):
                time.sleep(0.002)
            time.sleep(0.002)
    rec = trace.disable()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    exported = json.loads(path.read_text())
    inner = next(e for e in exported["traceEvents"]
                 if e.get("name") == "inner_range")
    outer, = rec.chrome_events(int(exported["baseTimeNanoseconds"]))
    assert outer["ph"] == "X" and outer["tid"] == threading.get_native_id()
    assert outer["args"]["pthread"] == threading.get_ident() & 0xFFFFFFFF
    o0, o1 = outer["ts"], outer["ts"] + outer["dur"]
    i0, i1 = inner["ts"], inner["ts"] + inner["dur"]
    assert o0 <= i0 and i1 <= o1
    assert i0 - o0 <= 20_000 and o1 - i1 <= 20_000       # µs
    assert rec.drift_ns() is not None


def test_a_served_request_holds_its_spans(recording, toy):
    corpus, index, loader = toy
    mono = tce.MonoScorer(tce.EncoderConfig(name="torch-trace-serve",
                                            **SMALL), device="cpu")
    topics = corpus.get_topics()
    svc = PipelineService(index.bm25(num_results=5) % 5 >> loader >> mono,
                          max_batch=4, max_wait_ms=20.0, max_workers=2)
    try:
        with ThreadPoolExecutor(6) as pool:
            futs = list(pool.map(lambda i: svc.submit(
                topics["qid"][i], topics["query"][i]), range(6)))
            for f in futs:
                assert len(f.result(timeout=60)) == 5
    finally:
        svc.close()
    rec = trace.disable()
    reqs = rec.named("serve.request")
    assert len(reqs) == 6 and len({r.req for r in reqs}) == 6
    for r in reqs:
        rid = r.req
        queue = [s for s in rec.named("serve.queue") if s.req == rid]
        waits = [s for s in rec.named("serve.pool_wait")
                 if rid in s.requests]
        nodes = [s for s in rec.named("plan.node") if rid in s.requests]
        calls = [s for s in rec.named("encoder.call") if rid in s.requests]
        assert len(queue) == 1 and len(waits) == 3 and len(nodes) == 3
        assert len(calls) == 1
        for s in queue + waits + nodes + calls:
            assert _inside(s, r), s.name
        node_ids = {n.id for n in nodes}
        assert calls[0].parent in node_ids


def test_plan_compile_time(recording, toy):
    corpus, index, loader = toy
    topics = corpus.get_topics()
    with tcore.ExecutionPlan([index.bm25(num_results=5) % 3 >> loader,
                              index.bm25(num_results=5) % 4]) as plan:
        _, stats = plan.run(topics)
    rec = trace.disable()
    assert stats.compile_time_s > 0
    span, = rec.named("plan.compile")
    assert (span.t1 - span.t0) * 1e-9 == stats.compile_time_s
    assert sorted(stats.node_exec_counts) == sorted(
        {s.attrs["node"] for s in rec.named("plan.node")})


def test_tokenize_pairs_equal_invocations(recording, toy):
    corpus, index, loader = toy
    cfg = tce.EncoderConfig(name="torch-trace-exp", **SMALL)
    mono = tce.MonoScorer(cfg, device="cpu")
    duo = tce.DuoScorer(cfg, max_docs=4, device="cpu")
    bm25 = index.bm25(num_results=20)
    systems = [bm25 % k >> loader >> mono % 4 >> duo for k in (5, 20)]
    topics = corpus.get_topics().head(6)
    tcore.Experiment(systems, topics, corpus.get_qrels(), ["nDCG@10"],
                     names=["a", "b"], precompute_prefix=True)
    rec = trace.disable()
    pairs = sum(s.attrs["pairs"] for s in rec.named("encoder.tokenize"))
    assert pairs == mono.invocations + duo.invocations > 0
    calls = rec.named("encoder.call")
    assert rec.counters["encoder.tokens_computed"] == \
        sum(c.attrs["rows"] * c.attrs["seq"] for c in calls)
    assert all(c.attrs["seq"] <= cfg.max_len for c in calls)
    assert 0 < rec.counters["encoder.tokens_useful"] \
        <= rec.counters["encoder.tokens_computed"]
    assert sum(mono._runner.shapes_issued.values()) \
        + sum(duo._runner.shapes_issued.values()) == len(calls)
    for name in ("encoder.h2d", "encoder.replay", "encoder.sync"):
        assert sorted(s.parent for s in rec.named(name)) == \
            sorted(c.id for c in calls)
    assert len(rec.named("experiment.evaluate")) == 1
    assert len(rec.named("bm25.retrieve")) == 1
