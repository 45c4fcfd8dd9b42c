"""The traffic and the data the harness finds by name: the open-loop
schedule comes from the seed and latencies run from the due time; every
cell's configuration, traffic mix, limits and metric readers load."""
import json
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest

from perfbench import harness
from perfbench.traffic import open_loop
from perfbench.traffic.corpus import make_corpus

SPEC = json.loads((Path(harness.ROOT) / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
MIX = {"rate_per_s": 20.0, "arrival_seed": 5, "drain_s": 5}


def test_schedule_is_the_mixs():
    a = open_loop.schedule(MIX, 10.0)
    assert np.array_equal(a, open_loop.schedule(MIX, 10.0))
    assert not np.array_equal(
        a, open_loop.schedule(dict(MIX, arrival_seed=6), 10.0)[:len(a)])
    assert a[0] == 0.0 and (np.diff(a) > 0).all() and a[-1] < 10.0
    assert 120 < len(a) < 280                  # Poisson at 20/s over 10 s
    assert np.array_equal(open_loop.schedule(MIX, 5.0), a[a < 5.0])


class _Service:
    """Answers after ``delay``; the first call blocks the sender."""

    class stats:
        requests = 0
        batches = 0

    def __init__(self, delay):
        self.delay = delay
        self.calls = 0

    def submit(self, qid, query):
        self.calls += 1
        if self.calls == 1:
            time.sleep(0.3)
        fut = Future()
        threading.Timer(self.delay, fut.set_result, args=[_Frame(qid)]).start()
        return fut

    def plan_stats(self):
        class S:
            cache_hits = 0
        return S()


class _Frame(dict):
    def __init__(self, qid):
        super().__init__(qid=np.array([qid]), docno=np.array(["d"]),
                         score=np.array([1.0]), rank=np.array([0]))

    def __len__(self):
        return 1


def test_latency_runs_from_the_due_time():
    corpus = make_corpus("s", n_docs=200, n_topics=50, seed=1)
    run = harness.Run(None, seed=3, seconds=1.0, trace=False, device="cpu")
    run.cell = harness.Cell("x", {}, dict(MIX, rate_per_s=20.0), {}, [], [])
    st = {"corpus": corpus, "service": _Service(0.05),
          "order": np.arange(50), "mono": type("M", (), {"invocations": 0})}
    rec = open_loop.window(run, st, 1.0)
    lat = rec["latencies_ms"]
    due = open_loop.schedule(run.traffic, 1.0)
    assert rec["attempted"] == len(due) and rec["failed"] == 0
    assert (lat >= 50.0 - 1.0).all()
    # the requests due while the first submit blocked the sender waited
    blocked = due < 0.3
    assert lat[blocked][-1] > 50.0 + (0.3 - due[blocked][-1]) * 1e3 - 5.0
    assert np.median(lat[~blocked]) < 150.0


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.traffic["driver"] in ("table2", "open_loop")
    assert {"hidden_size", "num_hidden_layers", "num_attention_heads",
            "intermediate_size", "vocab_size", "max_position_embeddings",
            "torch_dtype", "corpus_passages"} <= set(c.config)
    assert [m["name"] for m in c.end_to_end][-1] == "setup_s"
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))


def test_every_metric_has_a_reader_and_every_config_a_file():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (Path(harness.PACKAGE) / "metrics"
                / f"{m['name']}.py").is_file()
    for c in SPEC["configs"]:
        cfg = json.loads((Path(harness.ROOT) / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert set(c["reduced"]) <= set(cfg["reduced"])
