"""The port's serving path (``repro_torch.serve`` and the streaming
executor of ``repro_torch.core.executor``) against the reference's
(``repro.serve``): served results bit-identical to an offline plan run
under 4 client threads, coalescing, the three flush triggers, cold then
warm hit rates, the bounded reservoir, thread-safe stats, error
propagation, every registry scenario (scale 0.02; the reference's
encoder weights bridged in, scores within 1e-5), the closed-loop
records, offline warming, and the fleet and ``cli cache`` that used to
refuse.  Counts are
compared where batch composition is fixed by the size trigger or an
explicit flush, as the reference's tests do."""
import io
import json
import threading
import time
import zlib
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.executor as jexec
import repro.ir as jir
import repro.serve as jserve
import repro.caching as jcache
import repro_torch.caching as tcache
import repro_torch.core as tcore
import repro_torch.core.executor as texec
import repro_torch.ir as tir
import repro_torch.serve as tserve
from repro_torch.caching.provenance import set_digest_device

torch.set_num_threads(1)
set_digest_device("cpu")

PKGS = {"ref": (jcore, jir, jserve, jcache),
        "port": (tcore, tir, tserve, tcache)}
SCENARIOS = ["bm25", "bm25-mono", "mono", "dense", "hybrid", "bm25-sim"]
#: |port - reference| of a bridged encoder's scores (fp32 on the CPU)
SCORE_TOL = 1e-5


class _Env:
    """Corpus, index and topics of one package at scale 0.02."""

    def __init__(self, core, ir):
        self.core, self.ir = core, ir
        self.corpus = ir.msmarco_like(1, scale=0.02)
        self.index = ir.InvertedIndex.build(self.corpus.get_corpus_iter())
        self.topics = self.corpus.get_topics()

    def np_reranker(self):
        """Deterministic numpy pointwise reranker: row-local, so exact
        under any batching (crc32, the same in every process)."""
        core = self.core

        def fn(frame):
            if len(frame) == 0:
                return frame
            scores = np.array(
                [(zlib.crc32(f"{q}|{d}".encode()) % 100003) / 1000.0
                 for q, d in zip(frame["query"].tolist(),
                                 frame["docno"].tolist())],
                dtype=np.float64)
            return core.add_ranks(frame.assign(score=scores))
        return core.GenericTransformer(
            fn, "np_rerank", key_columns=("query", "docno"),
            value_columns=("score",))

    def two_stage(self):
        return (self.index.bm25(num_results=50) % 10
                >> self.ir.TextLoader(self.corpus.text_map())
                >> self.np_reranker())


@pytest.fixture(autouse=True, scope="module")
def reference_compile_cache_left_as_found():
    """The reference's process-wide compile cache keys an executable by
    name and input shape, not by weights (ROADMAP Queue C reference
    item 1), so the registry's ``mono-ce`` scorers compiled here would
    serve another file's ``mono-ce`` scorer of the same shape later in
    this process (``tests/test_system.py``'s).  Drop what this file
    added."""
    from repro.caching.compile_cache import default_compile_cache as cc
    before = set(cc._mem)
    yield
    for key in set(cc._mem) - before:
        cc._mem.pop(key, None)


ENVS = {k: _Env(core, ir) for k, (core, ir, _, _) in PKGS.items()}
T = ENVS["port"]


def per_qid(frame):
    return {str(k[0]): frame.take(idx)
            for k, idx in frame.group_indices(["qid"]).items()}


def same_rows(a, b, tol=0.0):
    """Equal qids and docnos in (qid, docno) order, scores within
    ``tol`` (exact at 0), for frames of either package."""
    a, b = a.sort_values(["qid", "docno"]), b.sort_values(["qid", "docno"])
    if [str(x) for x in a["qid"].tolist()] != \
            [str(x) for x in b["qid"].tolist()]:
        return False
    if a["docno"].tolist() != b["docno"].tolist():
        return False
    x = np.asarray(a["score"], dtype=np.float64)
    y = np.asarray(b["score"], dtype=np.float64)
    return bool(np.array_equal(x, y)) if tol == 0 else \
        bool(np.all(np.abs(x - y) <= tol))


# -- served == offline --------------------------------------------------------

def test_served_scores_bit_identical_to_offline_concurrent():
    """Four client threads over overlapping slices of the topics: each
    qid's served frame equals the offline plan run bit for bit, and
    equals the reference's offline run too."""
    pipeline = T.two_stage()
    offline, _ = tcore.ExecutionPlan([pipeline]).run(T.topics)
    ref = per_qid(offline[0])
    jref = per_qid(jcore.ExecutionPlan(
        [ENVS["ref"].two_stage()]).run(ENVS["ref"].topics)[0][0])
    svc = tserve.PipelineService(pipeline, max_batch=8, max_wait_ms=20,
                                 max_workers=4)
    results, lock = {}, threading.Lock()
    qids, queries = T.topics["qid"].tolist(), T.topics["query"].tolist()

    def client(cid):
        for i in range(cid, len(qids), 2):       # several clients per query
            out = svc.submit(qids[i], queries[i]).result(60)
            with lock:
                results[str(qids[i])] = out

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    svc.close()
    assert set(results) == set(ref) == set(jref)
    for qid, out in results.items():
        assert same_rows(out, ref[qid]) and same_rows(out, jref[qid])
        got = out.sort_values(["docno"])
        assert np.array_equal(got["rank"],
                              ref[qid].sort_values(["docno"])["rank"])


def test_search_matches_offline_whole_frame():
    pipeline = T.two_stage()
    offline, _ = tcore.ExecutionPlan([pipeline]).run(T.topics)
    with tserve.PipelineService(pipeline, max_wait_ms=0) as svc:
        served = svc.search(T.topics)
    assert same_rows(served, offline[0])


# -- coalescing ---------------------------------------------------------------

def _shared_query_stats(env, serve):
    calls = {"n": 0}
    inner = env.index.bm25(num_results=20)

    def counted(frame):
        calls["n"] += len(frame)
        return inner(frame)

    retriever = env.core.GenericTransformer(
        counted, "counted_bm25", key_columns=("qid", "query"),
        one_to_many=True)
    svc = serve.PipelineService(retriever, max_batch=6, max_wait_ms=2000,
                                max_workers=2)
    futs = [svc.submit("q0", "shared query text") for _ in range(6)]
    outs = [f.result(60) for f in futs]
    stats = svc.plan_stats()
    svc.close()
    assert all(len(o) == len(outs[0]) for o in outs)
    return (calls["n"], stats.node_exec_counts, stats.online["rows_in"],
            stats.online["rows_executed"], len(outs[0]))


def test_shared_query_executes_retrieval_once_as_reference():
    got = {k: _shared_query_stats(ENVS[k], PKGS[k][2]) for k in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"][:4] == \
        (1, {"GenericTransformer('counted_bm25',)": 1}, 6, 1)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_conflicting_qid_rows_do_not_coalesce(pkg):
    env, serve = ENVS[pkg], PKGS[pkg][2]
    svc = serve.PipelineService(env.np_reranker(), max_batch=4,
                                max_wait_ms=500, max_workers=2)
    rowa = {"qid": "q0", "query": "qq", "docno": "d1", "text": "ta",
            "score": 0.0, "rank": 0}
    rowb = dict(rowa, docno="d2", text="tb")
    fa, fb = svc._exec.submit([rowa]), svc._exec.submit([rowb])
    a, b = fa.result(60), fb.result(60)
    svc.close()
    assert a["docno"].tolist() == ["d1"] and b["docno"].tolist() == ["d2"]


# -- flush triggers -----------------------------------------------------------

@pytest.mark.parametrize("trigger", ["size", "timeout", "forced"])
def test_flush_triggers(trigger):
    kw = {"size": dict(max_batch=4, max_wait_ms=30_000),
          "timeout": dict(max_batch=100, max_wait_ms=50),
          "forced": dict(max_batch=100, max_wait_ms=30_000)}[trigger]
    n = {"size": 4, "timeout": 2, "forced": 1}[trigger]
    svc = tserve.PipelineService(T.two_stage(), max_workers=2, **kw)
    t0 = time.perf_counter()
    futs = [svc.submit(T.topics["qid"][i], T.topics["query"][i])
            for i in range(n)]
    if trigger == "forced":
        svc.flush()
    for f in futs:
        f.result(60)                 # long before a 30 s window would end
    dt = time.perf_counter() - t0
    s = svc.online_stats
    svc.close()
    counts = {"size": s.flush_size, "timeout": s.flush_timeout,
              "forced": s.flush_forced}
    assert counts[trigger] >= 1 and dt < 10
    assert all(v == 0 for k, v in counts.items() if k != trigger)


# -- cold then warm -----------------------------------------------------------

def _cold_then_warm(env, serve, root):
    """Eight requests one at a time (``max_batch=1``: every batch is one
    request, so counts do not depend on timing) against a fresh
    directory, then against the same directory from a new service."""
    pipeline = env.two_stage()
    qids = env.topics["qid"].tolist()[:8]
    queries = env.topics["query"].tolist()[:8]
    rows = []
    for _ in range(2):
        svc = serve.PipelineService(pipeline, cache_dir=root, max_batch=1,
                                    max_wait_ms=5)
        outs = [svc.submit(q, t).result(60) for q, t in zip(qids, queries)]
        st = svc.plan_stats()
        rows.append((outs, (svc.stats.cache_hits, svc.stats.cache_misses,
                            svc.stats.requests, svc.stats.batches,
                            st.cache_hits, st.cache_misses)))
        svc.close()
    return rows


def test_cold_then_warm_hit_rates_equal_reference(tmp_path):
    got = {k: _cold_then_warm(ENVS[k], PKGS[k][2], str(tmp_path / k))
           for k in PKGS}
    assert [r[1] for r in got["port"]] == [r[1] for r in got["ref"]]
    (cold_outs, cold), (warm_outs, warm) = got["port"]
    assert cold[1] > 0 and warm[0] > 0 and warm[1] == 0
    for a, b, c in zip(cold_outs, warm_outs, got["ref"][1][0]):
        assert same_rows(a, b) and same_rows(a, c)


def test_streaming_prefetch_attributes_hits_as_reference(tmp_path):
    """A warm service prefetches at submit time: with prefetch on,
    ``cache_prefetched`` > 0 and <= the hits, 0 with it off; results
    equal the offline run; counts equal the reference's."""
    got = {}
    for k, (core, _, serve, _) in PKGS.items():
        env = ENVS[k]
        pipeline = env.index.bm25(num_results=20) % 5
        with core.ExecutionPlan([pipeline], cache_dir=str(tmp_path / k)) \
                as plan:
            offline = plan.run(env.topics)[0][0]          # warms the store
        rows = []
        for prefetch in (True, False):
            with serve.PipelineService(pipeline, cache_dir=str(tmp_path / k),
                                       prefetch=prefetch,
                                       max_wait_ms=0.0) as svc:
                served = svc.search(env.topics)
                st = svc.plan_stats()
            assert same_rows(served, offline)
            rows.append((st.cache_hits, st.cache_misses,
                         st.cache_prefetched))
        got[k] = rows
    assert got["port"] == got["ref"]
    (h, m, p), (h2, m2, p2) = got["port"]
    assert m == m2 == 0 and h == h2 > 0 and 0 < p <= h and p2 == 0


# -- stats ---------------------------------------------------------------------

@pytest.mark.parametrize("capacity,seed", [(128, 0), (16, 3), (4096, 1)])
def test_reservoir_bounded_and_equal_reference(capacity, seed):
    r = texec.Reservoir(capacity=capacity, seed=seed)
    j = jexec.Reservoir(capacity=capacity, seed=seed)
    values = [float(i % 100) + 0.25 * (i % 7) for i in range(10_000)]
    for v in values:
        r.add(v)
    j.extend(values)
    assert len(r) == min(capacity, 10_000) and r.count == 10_000
    assert r.snapshot() == j.snapshot()
    for p in (50, 90, 99):
        assert r.percentile(p) == j.percentile(p)
    assert (r.mean, r.max) == (j.mean, j.max)
    if capacity == 128:
        assert 30 <= r.percentile(50) <= 70 and r.percentile(99) >= 80


def test_service_stats_thread_safe():
    stats = tserve.ServiceStats(reservoir_capacity=64)

    def hammer():
        for _ in range(500):
            stats.record_batch(n_requests=1, latencies_ms=[1.0])
            stats.add_cache_counts(2, 1)

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (stats.requests, stats.batches) == (4000, 4000)
    assert (stats.cache_hits, stats.cache_misses) == (8000, 4000)
    assert len(stats.latencies) == 64
    assert stats.summary().keys() == \
        jserve.ServiceStats(reservoir_capacity=64).summary().keys()


def test_streaming_executor_propagates_errors():
    def boom(frame):
        raise RuntimeError("stage exploded")

    svc = tserve.PipelineService(tcore.GenericTransformer(boom, "boom"),
                                 max_batch=2, max_wait_ms=5)
    fut = svc.submit("q1", "a query")
    with pytest.raises(RuntimeError, match="stage exploded"):
        fut.result(60)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc._exec.submit([{"qid": "q2", "query": "x"}])
    ok = tserve.PipelineService(tcore.GenericTransformer(lambda f: f, "id2"),
                                max_batch=2, max_wait_ms=5)
    assert ok.submit("q1", "a query").result(60)["qid"].tolist() == ["q1"]
    ok.close()


# -- single-key read-through fast paths ---------------------------------------

def test_single_key_fast_paths_count_as_reference():
    got = {}
    for k, (core, _, _, cache) in PKGS.items():
        env = ENVS[k]
        shout = core.GenericTransformer(
            lambda f: f.assign(out=np.asarray(
                [s + "!" for s in f["text"].tolist()], dtype=object)),
            "shout", key_columns=("text",), value_columns=("out",))
        kv = cache.KeyValueCache(None, shout, key="text", value="out")
        one = core.ColFrame({"text": ["hello"]})
        outs = [kv(one)["out"].tolist(), kv(one)["out"].tolist()]
        counts = [(kv.stats.hits, kv.stats.misses), kv.pop_call_counts(),
                  kv.pop_call_counts(), kv.call_with_counts(one)[1:]]
        kv.close()
        rc = cache.RetrieverCache(None, env.index.bm25(num_results=10))
        q = core.ColFrame({"qid": ["q1"], "query": [env.topics["query"][0]]})
        cold, warm = rc(q), rc(q)
        counts.append((rc.stats.hits, rc.stats.misses))
        rc.close()
        assert same_rows(cold, warm)
        got[k] = (outs, counts, cold["docno"].tolist())
    assert got["port"] == got["ref"]
    assert got["port"][1][:4] == [(1, 1), (1, 1), (0, 0), (1, 0)]


# -- registry -------------------------------------------------------------------

def _find(t, cls_name):
    """Instances of ``cls_name`` inside a reference pipeline."""
    out, stack, seen = [], [t], set()
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if type(x).__name__ == cls_name:
            out.append(x)
        if isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, jcore.Transformer):
            stack.extend(vars(x).values())
    return out


def bridged_params(jscenario):
    """The reference scenario's encoder weights as numpy trees."""
    params = {}
    for mono in _find(jscenario.pipeline, "MonoScorer"):
        params["mono"] = jax.tree.map(np.asarray, mono.params)
    for dense in _find(jscenario.pipeline, "DenseRetriever"):
        params["dense"] = jax.tree.map(np.asarray,
                                       dense.index.encoder.params)
    return params


@pytest.mark.parametrize("name", SCENARIOS)
def test_registry_scenario_equals_reference(name):
    js = jserve.build_scenario(name, scale=0.02)
    ts = tserve.build_scenario(name, scale=0.02, device="cpu",
                               params=bridged_params(js))
    assert (ts.name, ts.description) == (js.name, js.description)
    assert ts.topics["qid"].tolist() == js.topics["qid"].tolist()
    assert ts.topics["query"].tolist() == js.topics["query"].tolist()
    assert ts.request_extra == js.request_extra
    assert repr(ts.pipeline) == repr(js.pipeline)
    jf, tf = jserve.warming_frame(js), tserve.warming_frame(ts)
    assert tf.to_dicts() == jf.to_dicts()
    tol = SCORE_TOL if name in ("bm25-mono", "mono", "dense", "hybrid") \
        else 0.0
    assert same_rows(ts.pipeline(tf), js.pipeline(jf), tol)


def test_registry_refuses_unknown_and_defaults_to_cuda():
    with pytest.raises(KeyError):
        tserve.build_scenario("no-such-pipeline", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.build_scenario("bm25", scale=0.02)


# -- closed loop, warming, entry points ------------------------------------------

def test_drive_closed_loop_records_carry_reference_keys():
    recs = {}
    for k, (_, _, serve, _) in PKGS.items():
        kw = {"device": "cpu"} if k == "port" else {}
        cfg = serve.ServeConfig(pipeline="bm25", scale=0.02, cutoff=5,
                                max_batch=8, max_wait_ms=2.0,
                                backend="memory", **kw)
        recs[k] = serve.drive_closed_loop(cfg, requests=40, clients=4)
    assert recs["port"].keys() == recs["ref"].keys()
    assert recs["port"]["online"].keys() == recs["ref"]["online"].keys()
    for key in ("pipeline", "description", "optimize", "max_batch",
                "max_wait_ms", "workers", "requests", "clients"):
        assert recs["port"][key] == recs["ref"][key]
    assert recs["port"]["requests"] == 40


def test_drive_closed_loop_takes_a_built_scenario(monkeypatch):
    """A built scenario skips the registry, as in ``build_service``."""
    cfg = tserve.ServeConfig(pipeline="bm25", scale=0.02, cutoff=5,
                             max_batch=8, backend="memory", device="cpu")
    scen = cfg.build_scenario()

    def no_rebuild(self):
        raise AssertionError("the scenario was built again")
    monkeypatch.setattr(tserve.ServeConfig, "build_scenario", no_rebuild)
    rec = tserve.drive_closed_loop(cfg, scenario=scen, requests=30,
                                   clients=3)
    assert (rec["requests"], rec["description"]) == \
        (30, scen.description)


def test_warm_scenario_then_service_misses_nothing(tmp_path):
    """``warm_scenario`` over the whole topic pool, in both packages:
    equal reports; then a port service over the warmed directory serves
    a closed loop without a miss."""
    reports = {}
    for k, (_, _, serve, cache) in PKGS.items():
        kw = {"device": "cpu"} if k == "port" else {}
        cfg = serve.ServeConfig(pipeline="bm25", scale=0.02, cutoff=5,
                                num_results=20, backend="sqlite",
                                cache_dir=str(tmp_path / k), **kw)
        reports[k] = cache.warm_scenario(None, str(tmp_path / k),
                                         config=cfg)
    for key in ("scenario", "backend", "queries_warmed", "cache_hits",
                "cache_misses", "nodes_executed"):
        assert reports["port"][key] == reports["ref"][key]
    assert reports["port"]["cache_misses"] == \
        reports["port"]["queries_warmed"] > 0
    cfg = tserve.ServeConfig(pipeline="bm25", scale=0.02, cutoff=5,
                             num_results=20, backend="sqlite", device="cpu",
                             cache_dir=str(tmp_path / "port"))
    rec = tserve.drive_closed_loop(cfg, requests=60, clients=4)
    assert rec["requests"] == 60 and rec["hit_rate"] == 1.0
    # plan.warm into another directory, a second warm all hits
    scen = cfg.build_scenario()
    frame = tserve.warming_frame(scen)
    with tcore.ExecutionPlan([scen.pipeline],
                             cache_dir=str(tmp_path / "w")) as plan:
        first = plan.warm(frame, chunk_rows=7)
        second = plan.warm(frame)
    assert (first.cache_misses, second.cache_hits, second.cache_misses) \
        == (len(frame), len(frame), 0)


def test_fleet_and_cache_tooling_refuse_with_their_reasons(tmp_path,
                                                           monkeypatch):
    """What used to refuse now runs: ``ServeConfig(workers=2)`` and
    ``build_service(workers=2)`` give a spawned fleet whose per-qid
    results equal the in-process service's, and ``cli cache`` lists and
    verifies the directory the fleet wrote; ``workers=0`` is still
    refused."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = tserve.ServeConfig(workers=2, device="cpu", pipeline="bm25",
                             scale=0.02, cutoff=5, max_batch=4,
                             warm_start=False,
                             cache_dir=str(tmp_path / "c"))
    scen = cfg.build_scenario()
    qids = [str(q) for q in scen.topics["qid"].tolist()][:8]
    queries = scen.topics["query"].tolist()[:8]
    with tserve.build_service(cfg.single(), scenario=scen) as one:
        want = [one.submit(q, t) for q, t in zip(qids, queries)]
        one.flush()
        want = [f.result(120) for f in want]
    with tserve.build_service(cfg.single(), workers=2) as fleet:
        assert isinstance(fleet, tserve.FleetService)
        got = [f.result(120) for f in [fleet.submit(q, t)
                                       for q, t in zip(qids, queries)]]
        assert set(fleet.drain()["exit_codes"].values()) == {0}
    for g, w in zip(got, want):
        assert g.equals(w)
    from repro_torch.cli import main
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["cache", "ls", str(tmp_path / "c"), "--json"]) == 0
    dirs = json.loads(buf.getvalue())["dirs"]
    assert dirs and all(d["entry_count"] > 0 for d in dirs)
    with redirect_stdout(io.StringIO()):
        assert main(["cache", "verify", str(tmp_path / "c")]) == 0
    with pytest.raises(ValueError):
        tserve.ServeConfig(workers=0)


@pytest.mark.parametrize("knob,value", [("routing", "qid"),
                                        ("warm_start", False),
                                        ("warm_budget", 3),
                                        ("extra", {"a": 1})])
def test_fleet_only_knobs_wait_for_the_fleet(knob, value):
    """The fleet's knobs came with the fleet: the port takes each one
    the reference's fleet reads, with its value; ``extra``, which
    nothing reads, it still refuses rather than ignore."""
    ref = jserve.ServeConfig(**{knob: value})
    if knob == "extra":
        with pytest.raises(TypeError):
            tserve.ServeConfig(device="cpu", **{knob: value})
        return
    got = tserve.ServeConfig(device="cpu", **{knob: value})
    assert getattr(got, knob) == getattr(ref, knob) == value
    assert getattr(got.single(), knob) == value


def test_cli_serve_has_no_warm_start_flag():
    """``--no-warm-start`` is back with the fleet: it parses, as in the
    reference, and turns the fleet's warm start off."""
    from repro_torch.cli import build_parser
    args = build_parser().parse_args(["serve", "--no-warm-start",
                                      "--device", "cpu", "--workers", "2"])
    assert args.no_warm_start is True and args.workers == 2
    assert build_parser().parse_args(["serve"]).no_warm_start is False
    import repro.cli as jcli
    jargs = jcli.build_parser().parse_args(["serve", "--no-warm-start"])
    assert jargs.no_warm_start is True


def test_cli_serve_and_plan_explain_round_trip(tmp_path):
    """``repro_torch.cli serve`` on the CPU writes its record; ``plan
    explain`` renders the recorded plan as ``explain()`` does."""
    from repro_torch.cli import main
    out = tmp_path / "rec.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["serve", "--pipeline", "bm25", "--scale", "0.02",
                   "--requests", "20", "--cache-dir", str(tmp_path / "c"),
                   "--device", "cpu", "--json", str(out)])
    assert rc == 0 and "served 20 requests" in buf.getvalue()
    rec = json.loads(out.read_text())
    assert rec["requests"] == 20 and rec["pipeline"] == "bm25"
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["plan", "explain", str(tmp_path / "c")]) == 0
    scen = tserve.build_scenario("bm25", scale=0.02, device="cpu")
    with tcore.ExecutionPlan([scen.pipeline],
                             cache_dir=str(tmp_path / "c")) as plan:
        assert buf.getvalue().strip().splitlines()[0] == \
            plan.explain().splitlines()[0]
