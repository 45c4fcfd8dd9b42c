"""The port's asynchronous cache data plane (``repro_torch.caching.
dataplane`` and the families' prefetch / write-behind paths) against the
reference's: staging-map pop-once and in-flight-wait semantics,
write-behind overlay durability, compute-once under threads, both kill
switches, and the same plans in both packages cold, then warm with
prefetch on and off under the sequential and the concurrent executor —
hits, misses and prefetched counts equal to the reference's, outputs
bit-identical."""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import repro.caching as jcache
import repro.core as jcore
import repro_torch.caching as tcache
import repro_torch.core as tcore
from repro_torch.caching import StagingMap, WriteBehindWriter
from repro_torch.caching.provenance import set_digest_device
from _torch_parity import frames_equal, pin_round_trip, pipeline_sets, toy

torch.set_num_threads(1)
set_digest_device("cpu")

PKGS = {"ref": (jcore, jcache), "port": (tcore, tcache)}
#: every pass but ``cache-place`` and ``autotune``, which decide from
#: measured times and could keep a cache in one package only
PASSES = ["normalize", "cse", "pushdown", "operand-order", "cache-prune"]


# -- staging map --------------------------------------------------------------

def test_staging_map_pop_once_and_none_misses():
    s = StagingMap()
    s.deposit([(b"k1", b"v1"), (b"k2", None)])
    assert len(s) == 2
    got = s.pop_many([b"k1", b"k2", b"k3"])
    assert got == {b"k1": b"v1", b"k2": None}    # a staged miss is a result
    assert s.pop_many([b"k1"]) == {}             # consumed at most once
    s.deposit([(b"k4", b"v4")])
    s.discard()
    assert s.pop_many([b"k4"]) == {}


def test_staging_map_covered_dedups_inflight():
    s = StagingMap()
    s.deposit([(b"a", b"1")])
    fut = Future()
    s.track(fut, [b"b"])
    assert s.covered([b"a", b"b", b"c"]) == [b"c"]
    fut.set_result(None)                         # done callback untracks
    assert s.covered([b"b"]) == [b"b"]


def test_staging_map_pop_waits_for_inflight_fetch():
    s = StagingMap()
    fut = Future()
    s.track(fut, [b"k"])

    def land():
        time.sleep(0.05)
        s.deposit([(b"k", b"v")])
        fut.set_result(None)

    t = threading.Thread(target=land)
    t.start()
    try:
        assert s.pop_many([b"k"]) == {b"k": b"v"}    # waited, no re-read
    finally:
        t.join()


# -- write-behind writer ------------------------------------------------------

class _RecordingStore:
    def __init__(self, fail_times=0):
        self.rows = {}
        self.fail_times = fail_times

    def put_many(self, items):
        if self.fail_times > 0:
            self.fail_times -= 1
            raise OSError("transient store failure")
        self.rows.update(items)


def test_write_behind_overlay_readable_until_durable(monkeypatch):
    monkeypatch.setenv("REPRO_WRITE_BEHIND_HOLD", "1")
    store = _RecordingStore()
    w = WriteBehindWriter(store.put_many)
    w.put([(b"k1", b"v1"), (b"k2", b"v2")])
    assert w.pending == 2 and store.rows == {}       # held: nothing durable
    assert w.overlay_many([b"k1", b"k3"]) == {b"k1": b"v1"}
    assert w.barrier() is None and store.rows == {}  # barrier honors HOLD
    w.flush()
    assert store.rows == {b"k1": b"v1", b"k2": b"v2"}
    assert w.pending == 0 and w.overlay_many([b"k1"]) == {}
    w.close()
    with pytest.raises(RuntimeError):
        w.put([(b"k3", b"v3")])


def test_write_behind_failed_flush_keeps_entries_pending(monkeypatch):
    monkeypatch.setenv("REPRO_WRITE_BEHIND_HOLD", "1")
    store = _RecordingStore(fail_times=1)
    w = WriteBehindWriter(store.put_many)
    w.put([(b"k", b"v")])
    with pytest.raises(OSError):
        w.flush()
    # the entry stays readable and re-flushable — never silently lost
    assert w.pending == 1 and w.overlay_many([b"k"]) == {b"k": b"v"}
    w.flush()
    assert store.rows == {b"k": b"v"}


def test_write_behind_last_value_wins_and_order_preserved():
    flushed = []
    w = WriteBehindWriter(lambda items: flushed.extend(items))
    w._hold = True                               # deterministic pending state
    w.put([(b"k", b"v1")])
    w.put([(b"k", b"v2"), (b"j", b"w")])
    assert w.pending == 2                        # rewrite coalesced in place
    w.flush()
    assert flushed == [(b"k", b"v2"), (b"j", b"w")]


def test_kv_cache_async_writes_threads_compute_exactly_once(tmp_path):
    calls = []

    def upper(f):
        calls.extend(f["text"].tolist())
        return f.assign(out=np.array(
            [t.upper() for t in f["text"].tolist()], dtype=object))

    c = tcache.KeyValueCache(str(tmp_path / "kv"),
                             tcore.GenericTransformer(upper, "U"),
                             key="text", value="out", async_writes=True)
    assert c._writer is not None                 # write-behind is live
    frame = tcore.ColFrame({"text": [f"t{i}" for i in range(8)]})
    outs = [None] * 4

    def run(slot):
        outs[slot] = c.transform(frame)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(calls) == sorted(f"t{i}" for i in range(8))   # once each
    for o in outs:
        assert o["out"].tolist() == [f"T{i}" for i in range(8)]
    c.close()
    # the reference reads every entry back: all became durable
    warm = jcache.KeyValueCache(
        str(tmp_path / "kv"),
        jcore.GenericTransformer(lambda f: f, "U"), key="text", value="out")
    out = warm.transform(jcore.ColFrame({"text": [f"t{i}" for i in
                                                   range(8)]}))
    assert out["out"].tolist() == [f"T{i}" for i in range(8)]
    assert (warm.stats.hits, warm.stats.misses) == (8, 0)
    warm.close()


# -- kill switches ------------------------------------------------------------

def test_write_behind_kill_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_WRITE_BEHIND", "0")
    assert not tcache.write_behind_default()
    c = tcache.KeyValueCache(str(tmp_path / "kv"),
                             tcore.GenericTransformer(lambda f: f, "I"),
                             key="text", value="text", async_writes=True)
    assert c._writer is None                     # puts stay synchronous
    c.close()
    monkeypatch.delenv("REPRO_WRITE_BEHIND")
    assert tcache.write_behind_default()


def _plan_rows(core, root, run_kw, prefetches):
    t = toy(core)
    pipes = pipeline_sets(t)["mixed"]
    rows = []
    for prefetch in prefetches:
        with core.ExecutionPlan(pipes, cache_dir=root, optimize=PASSES,
                                prefetch=prefetch) as plan:
            outs, st = plan.run(t.queries(), **run_kw)
            stamped = sorted(n.label for n in plan.graph.nodes
                             if n.prefetch)
        rows.append((outs, (st.cache_hits, st.cache_misses,
                            st.cache_prefetched), stamped))
    return rows


def test_prefetch_kill_switch(tmp_path, monkeypatch):
    pin_round_trip(monkeypatch, 1e-5)
    monkeypatch.setenv("REPRO_PREFETCH", "0")
    assert not tcache.prefetch_default()
    got = {k: _plan_rows(core, str(tmp_path / k), {}, (True, True))
           for k, (core, _) in PKGS.items()}
    assert [r[1:] for r in got["port"]] == [r[1:] for r in got["ref"]]
    warm = got["port"][1]
    assert warm[1][1] == 0 and warm[1][2] == 0   # env veto beats the kwarg
    assert warm[2] == []                         # nothing stamped


# -- prefetch: parity, bit-identity and attribution across executors ---------

@pytest.mark.parametrize("run_kw", [
    pytest.param({}, id="sequential"),
    pytest.param({"n_shards": 3, "max_workers": 3}, id="concurrent"),
])
def test_cold_then_warm_prefetch_on_and_off_equal_reference(
        tmp_path, monkeypatch, run_kw):
    """Cold, warm with prefetch on, warm with it off: the same counts as
    the reference's (prefetched > 0 and <= hits when on, 0 when off),
    the same nodes stamped, outputs bit-identical across the runs and
    the packages."""
    pin_round_trip(monkeypatch, 1e-5)
    got = {k: _plan_rows(core, str(tmp_path / k), run_kw,
                         (True, True, False))
           for k, (core, _) in PKGS.items()}
    assert [r[1:] for r in got["port"]] == [r[1:] for r in got["ref"]]
    (cold_outs, cold, _), (on_outs, on, stamped), (off_outs, off, _) = \
        got["port"]
    assert cold[0] == 0 and cold[1] > 0 and cold[2] == 0
    assert on[:2] == off[:2] == (cold[1], 0)
    assert 0 < on[2] <= on[0] and off[2] == 0
    assert stamped                               # the plan stamped nodes
    for outs in (on_outs, off_outs, *(r[0] for r in got["ref"])):
        assert all(frames_equal(a, b) for a, b in zip(outs, cold_outs))


def test_warm_and_drain_equal_reference(tmp_path, monkeypatch):
    """``ExecutionPlan.warm`` fills the caches (misses = entries
    precomputed), a second warm is all hits, and after ``drain`` a fresh
    process-level reopen serves the run without a miss — in both
    packages alike."""
    pin_round_trip(monkeypatch, 1e-5)
    got = {}
    for k, (core, _) in PKGS.items():
        t = toy(core)
        pipes = pipeline_sets(t)["ablation"]
        root = str(tmp_path / k)
        plan = core.ExecutionPlan(pipes, cache_dir=root, optimize=PASSES)
        w1 = plan.warm(t.queries(), chunk_rows=1)
        w2 = plan.warm(t.queries())
        plan.drain()
        plan.close()
        with core.ExecutionPlan(pipes, cache_dir=root,
                                optimize=PASSES) as again:
            _, st = again.run(t.queries())
        got[k] = [(s.cache_hits, s.cache_misses, s.n_queries)
                  for s in (w1, w2, st)]
    assert got["port"] == got["ref"]
    (h1, m1, _), (h2, m2, _), (h3, m3, _) = got["port"]
    assert h1 == 0 and m1 > 0 and (h2, m2) == (m1, 0) and m3 == 0
