"""The port's multi-process serving fleet (``repro_torch.serve.fleet``)
against the reference's in-process ``PipelineService`` on the same
scenario: the ServeConfig surface, per-qid equality and a clean drain,
a closed loop equal to a single process, kill-a-worker, warm starts with
zero misses over ``mmap:sqlite``, both routing policies, repeated drains
with exactly one reaping thread per worker, and the workers' device
rules.  Every fleet runs on the CPU (``device="cpu"``) at the reference
tests' size; each test bounds its own waits."""
import collections
import os
import threading

import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro_torch.caching import warm_scenario
from repro_torch.caching.provenance import set_digest_device
from repro_torch.core import ColFrame
from repro_torch.serve import (FleetService, PipelineService, ServeConfig,
                               build_service, drive_closed_loop,
                               run_closed_loop)
from repro_torch.serve import fleet as tfleet

torch.set_num_threads(1)
set_digest_device("cpu")

WAIT = 120                               # seconds any one future may take


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Spawned workers inherit the environment: one OpenMP thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _cfg(pkg=tserve, **kw):
    """The reference tests' scenario (``tests/test_fleet.py``), on the
    CPU in the port."""
    base = dict(pipeline="bm25", scale=0.02, cutoff=5, num_results=20,
                seed=0, max_batch=4, max_wait_ms=0.0, exec_workers=1,
                warm_start=False)
    if pkg is tserve:
        base["device"] = "cpu"
    base.update(kw)
    return pkg.ServeConfig(**base)


def _reference_frames(cfg_kw, rows):
    """Per-row result frames of the reference's in-process service on
    the same scenario, as ``{qid: frame}``."""
    cfg = _cfg(jserve, **cfg_kw)
    scenario = cfg.build_scenario()
    out = {}
    with jserve.build_service(cfg, scenario=scenario) as svc:
        futs = [(qid, svc.submit(qid, query)) for qid, query in rows]
        svc.flush()
        for qid, fut in futs:
            out[qid] = fut.result(WAIT)
    return out


def _same(a, b):
    """Equal rows (qid, docno, score, rank), in order, for frames of
    either package."""
    cols = ("qid", "docno", "score", "rank")
    return all([str(x) for x in a[c].tolist()] ==
               [str(x) for x in b[c].tolist()] for c in cols)


def _rows(scenario):
    return list(zip([str(q) for q in scenario.topics["qid"].tolist()],
                    scenario.topics["query"].tolist()))


# -- ServeConfig surface ------------------------------------------------------

def test_serve_config_validates_eagerly():
    with pytest.raises(ValueError, match="workers"):
        ServeConfig(workers=0)
    with pytest.raises(ValueError, match="routing"):
        ServeConfig(routing="sticky")
    with pytest.raises(ValueError, match="selector"):
        ServeConfig(backend="bogus")
    # selectors are normalized at config time (what manifests record)
    assert ServeConfig(backend="mmap").backend == "mmap:sqlite"
    assert ServeConfig(backend=None).backend is None


def test_serve_config_coerce_and_single():
    cfg = ServeConfig.coerce({"pipeline": "bm25", "workers": 3,
                              "device": "cpu"})
    assert cfg.pipeline == "bm25" and cfg.workers == 3
    assert ServeConfig.coerce(cfg) is cfg
    assert ServeConfig.coerce(None) == ServeConfig()
    assert cfg.single().workers == 1
    assert cfg.single().pipeline == "bm25" and cfg.single().device == "cpu"
    with pytest.raises(TypeError, match="ServeConfig"):
        ServeConfig.coerce(42)


def test_serve_config_fields_are_the_references_and_device():
    """The fleet's knobs are back, with the reference's defaults;
    ``device`` is the port's own, and ``extra`` (which nothing reads)
    stays out."""
    import dataclasses
    t = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    j = {f.name: f.default for f in dataclasses.fields(jserve.ServeConfig)}
    assert set(t) == (set(j) - {"extra"}) | {"device"}
    for knob in ("workers", "routing", "warm_start", "warm_budget"):
        assert t[knob] == j[knob]


def test_build_service_dispatches_on_workers():
    svc = build_service(_cfg())
    try:
        assert isinstance(svc, PipelineService)
    finally:
        svc.close()
    with pytest.raises(ValueError, match="workers=1"):
        build_service(_cfg(workers=2), pipeline=object())
    with pytest.raises(ValueError, match="workers=1"):
        build_service(_cfg(workers=2), scenario=object())


# -- fleet behaviour ----------------------------------------------------------

def test_fleet_bit_identity_and_clean_drain(tmp_path):
    """Every topic served through a 2-worker fleet equals the reference's
    in-process service and the port's offline ``pipeline(topics)``
    frame; drain finishes in-flight work, refreshes the cache manifests
    and exits every worker 0."""
    cache_dir = str(tmp_path)
    cfg = _cfg(workers=2, cache_dir=cache_dir)
    scenario = cfg.build_scenario()
    offline = scenario.pipeline(scenario.topics)
    rows = _rows(scenario)
    ref = _reference_frames({}, rows)
    with build_service(cfg) as svc:
        assert isinstance(svc, FleetService)
        assert sorted(svc.worker_ids) == [0, 1]
        assert {i["device"] for i in svc.warm_info.values()} == {"cpu"}
        futs = [(qid, svc.submit(qid, query)) for qid, query in rows]
        for qid, fut in futs:
            served = fut.result(WAIT)
            assert served.equals(
                offline.take(np.nonzero(offline["qid"] == qid)[0])), qid
            assert _same(served, ref[qid]), qid
        report = svc.drain()
        assert set(report["exit_codes"].values()) == {0}
        assert report["lost_exit_codes"] == {}
        assert report["requeued"] == 0 and report["respawns"] == 0
        assert len(report["workers"]) == 2
        assert report["online"]["batches"] >= 1
        assert sum(w["requests"] for w in report["workers"]) == len(rows)
        for w in report["workers"]:
            assert w["device"] == "cpu"
            assert w["kernel_launches"] == {"dense_topk": 0,
                                            "cachekey_hash": 0}
            assert {"spawn", "imports", "scenario", "service", "warm"} <= \
                set(w["start_s"])
        assert svc.drain() is report                     # idempotent
        with pytest.raises(RuntimeError):
            svc.submit("q1", "after drain")
    # worker close() wrote provenance manifests for the shared caches
    assert [p for p in tmp_path.rglob("manifest.json")]


def test_fleet_closed_loop_matches_single_process(tmp_path):
    """``drive_closed_loop`` through a 2-worker fleet resolves the same
    request stream as the reference's single process: every request
    completes, the record carries the reference's keys plus the fleet
    report, and the drained cache totals are the fleet's."""
    cfg = _cfg(workers=2, cache_dir=str(tmp_path / "t"), backend="sqlite")
    rec = drive_closed_loop(cfg, requests=40, clients=4, drain=True)
    ref = jserve.drive_closed_loop(
        _cfg(jserve, cache_dir=str(tmp_path / "j"), backend="sqlite"),
        requests=40, clients=4)
    assert rec["requests"] == ref["requests"] == 40
    assert set(rec) == set(ref) | {"fleet", "drained"}
    assert rec["drained"] is True and rec["workers"] == 2
    assert rec["online"] == rec["fleet"]["online"]
    assert rec["online"]["cache_hits"] + rec["online"]["cache_misses"] > 0
    with build_service(cfg) as svc:
        loop = run_closed_loop(svc, cfg.build_scenario(),
                               n_requests=40, n_clients=4, seed=0)
        assert loop["requests"] == 40
        assert svc.drain()["online"]["cache_misses"] == 0   # now warm


def test_kill_worker_loses_no_accepted_request():
    """SIGKILL one worker with requests in flight: the demux requeues
    its accepted work to survivors and respawns the slot — every
    submitted future still resolves, to the reference's result.  Uses
    the bm25-sim scenario so requests take long enough to be in
    flight."""
    kw = dict(pipeline="bm25-sim", max_batch=1)
    cfg = _cfg(workers=3, **kw)
    scenario = cfg.build_scenario()
    rows = _rows(scenario)
    ref = _reference_frames(kw, rows)
    with FleetService(cfg) as svc:
        futs = []
        for i in range(60):                              # open loop
            futs.append(svc.submit(*rows[i % len(rows)]))
        killed = svc.kill_worker()                       # chaos, mid-stream
        frames = [f.result(WAIT) for f in futs]          # nothing lost
        assert len(frames) == 60
        for i, frame in enumerate(frames):
            assert _same(frame, ref[rows[i % len(rows)][0]])
        assert svc.respawns >= 1
        report = svc.drain()
        # the killed worker's exit is recorded apart; survivors and
        # the respawned slot all drain cleanly
        assert killed not in report["exit_codes"]
        assert report["lost_exit_codes"][killed] == -9
        live_codes = list(report["exit_codes"].values())
        assert len(live_codes) == 3 and all(c == 0 for c in live_codes)


def test_fleet_warm_start_zero_misses(tmp_path):
    """Precompute the store offline, then serve with a fleet over the
    mmap read-mostly tier: every worker warms from the manifests on
    start and the serve epoch never misses; the warm counts are the
    reference's."""
    cfg = _cfg(workers=2, cache_dir=str(tmp_path / "t"),
               backend="mmap:sqlite", warm_start=True)
    offline = warm_scenario(None, cfg.cache_dir, config=cfg)
    jcfg = _cfg(jserve, cache_dir=str(tmp_path / "j"),
                backend="mmap:sqlite", warm_start=True)
    import repro.caching as jcache
    joffline = jcache.warm_scenario(None, jcfg.cache_dir, config=jcfg)
    assert offline["queries_warmed"] == joffline["queries_warmed"] > 0
    assert offline["cache_misses"] == joffline["cache_misses"]
    with FleetService(cfg) as svc:
        for wid, info in svc.warm_info.items():
            assert info["warm_misses"] == 0              # store was complete
            assert info["warm_hits"] == offline["cache_misses"] > 0
            assert info["queries_warmed"] == offline["queries_warmed"]
        loop = run_closed_loop(svc, cfg.build_scenario(),
                               n_requests=40, n_clients=4, seed=0)
        assert loop["requests"] == 40
        report = svc.drain()
        assert report["online"]["cache_misses"] == 0     # no cold misses
        assert report["online"]["cache_hits"] > 0
        assert set(report["exit_codes"].values()) == {0}


@pytest.mark.parametrize("routing", ["rr", "qid"])
def test_routing_policies_serve_the_references_results(routing):
    """Both policies give the reference's per-qid results.  ``rr``
    alternates the workers request by request; ``qid`` sends every
    request of a qid to the worker its crc32 picks."""
    cfg = _cfg(workers=2, routing=routing)
    scenario = cfg.build_scenario()
    rows = _rows(scenario) * 2
    ref = _reference_frames({}, _rows(scenario))
    with FleetService(cfg) as svc:
        for qid, fut in [(q, svc.submit(q, query)) for q, query in rows]:
            assert _same(fut.result(WAIT), ref[qid]), qid
        report = svc.drain()
    per_worker = {w["worker"]: w["requests"] for w in report["workers"]}
    if routing == "rr":
        assert per_worker == {0: len(rows) // 2, 1: len(rows) // 2}
    else:
        want = collections.Counter(tfleet._qid_slot(q, 2) for q, _ in rows)
        assert per_worker == dict(want)


def test_repeated_drains_exit_zero_with_one_reaper_per_worker(monkeypatch):
    """Five 2-worker fleets in a row, each drained: exit codes ``{0}``
    every time, and every worker process is reaped by exactly one
    ``os.waitpid`` call, made by its own ``fleet-reaper-<id>`` thread,
    with no ``ECHILD`` anywhere (the reference's drain joined from two
    threads)."""
    real_waitpid = os.waitpid
    calls = []

    def recording_waitpid(pid, options):
        try:
            got = real_waitpid(pid, options)
        except OSError as e:
            calls.append((threading.current_thread().name, pid, e))
            raise
        calls.append((threading.current_thread().name, pid, got))
        return got
    monkeypatch.setattr(os, "waitpid", recording_waitpid)
    cfg = _cfg(workers=2)
    scenario = cfg.build_scenario()
    rows = _rows(scenario)[:6]
    for _ in range(5):
        with FleetService(cfg) as svc:
            pids = {w.id: w.proc.pid for w in svc._all}
            for fut in [svc.submit(q, query) for q, query in rows]:
                fut.result(WAIT)
            report = svc.drain(timeout=60)
        assert set(report["exit_codes"].values()) == {0}, report
        assert len(report["exit_codes"]) == 2
        for wid, pid in pids.items():
            mine = [c for c in calls if c[1] == pid]
            assert not [c for c in mine if isinstance(c[2], OSError)]
            reaped = [c for c in mine if c[2][0] == pid]
            assert [c[0] for c in reaped] == [f"fleet-reaper-{wid}"]


# -- the worker's device and replies --------------------------------------------

def test_worker_device_rules(monkeypatch):
    """``"cpu"`` never touches CUDA; ``None``/``"cuda"`` without a card
    raise (no fallback); with cards, worker ``w`` takes
    ``cuda:{w % count}`` and makes it current."""
    assert tfleet._worker_device("cpu", 3) == "cpu"
    assert not torch.cuda.is_initialized()
    if not torch.cuda.is_available():
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tfleet._worker_device(dev, 0)
    picked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    assert [tfleet._worker_device(None, w) for w in range(3)] == \
        ["cuda:0", "cuda:1", "cuda:0"]
    assert tfleet._worker_device("cuda", 5) == "cuda:1"
    assert [str(d) for d in picked] == ["cuda:0", "cuda:1", "cuda:0",
                                        "cuda:1"]


def test_fleet_without_a_card_fails_at_start_rather_than_fall_back():
    """Workers default to CUDA: without a card each raises before it is
    ready, and the fleet fails with the exit code instead of
    respawning or serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    cfg = _cfg(workers=2, device=None)
    with pytest.raises(RuntimeError, match="before it was ready"):
        FleetService(cfg, start_timeout=WAIT)


def test_replies_carry_host_values_only():
    frame = ColFrame({"qid": ["q1"], "score": np.array([1.0])})
    tfleet._host_only(frame)
    tfleet._host_only({"a": [1, 2.0, "x"], "b": {"c": np.zeros(2)}})
    with pytest.raises(TypeError, match="only host values"):
        tfleet._host_only({"launches": torch.zeros(1)})
    emb = np.empty(1, dtype=object)
    emb[0] = torch.zeros(2)
    bad = ColFrame({"qid": ["q1"], "emb": emb})
    with pytest.raises(TypeError, match="column 'emb'"):
        tfleet._host_only(bad)


def test_cli_serve_workers_two_drains_every_worker(tmp_path):
    """``repro_torch.cli serve --workers 2 --drain`` on the CPU serves
    through a spawned fleet and reports the workers' exit codes, as the
    reference's CLI does."""
    import io
    import json
    from contextlib import redirect_stdout

    from repro_torch.cli import main
    out = tmp_path / "rec.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["serve", "--pipeline", "bm25", "--scale", "0.02",
                   "--cutoff", "5", "--requests", "24", "--workers", "2",
                   "--cache-dir", str(tmp_path / "c"), "--drain",
                   "--no-warm-start", "--device", "cpu",
                   "--json", str(out)])
    text = buf.getvalue()
    assert rc == 0, text
    assert "workers=2" in text
    assert "fleet: respawns=0 requeued=0 exit_codes=[0, 0]" in text
    rec = json.loads(out.read_text())
    assert rec["drained"] is True and rec["requests"] == 24
    assert {w["device"] for w in rec["fleet"]["workers"]} == {"cpu"}
