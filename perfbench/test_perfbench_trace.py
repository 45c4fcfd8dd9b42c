"""The device trace's arithmetic on a trace written by hand: busy time is
the union of device intervals inside the window, the encoder's device
time is what its calls launched, from any thread, and idle gaps are
named by the innermost span the host was in."""
import json

import pytest

from perfbench.trace import WINDOW_RANGE, summarize


def _trace(tmp_path):
    ev = [
        {"cat": "user_annotation", "name": WINDOW_RANGE, "ts": 1000.0,
         "dur": 1000.0, "tid": 1},
        # a graph launch inside an encoder call of a worker thread, which
        # the trace names by its pthread id's low bits, signed (-3)
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1105.0,
         "dur": 5.0, "tid": -3, "args": {"correlation": 11}},
        {"cat": "kernel", "name": "gemm", "ts": 1110.0, "dur": 200.0,
         "args": {"correlation": 11}},
        {"cat": "kernel", "name": "softmax", "ts": 1250.0, "dur": 100.0,
         "args": {"correlation": 11}},
        # a copy launched on the main thread outside any encoder call
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 1600.0,
         "dur": 5.0, "tid": 1, "args": {"correlation": 12}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1700.0,
         "dur": 50.0, "args": {"correlation": 12}},
        # before the window: not counted
        {"cat": "kernel", "name": "gemm", "ts": 900.0, "dur": 50.0,
         "args": {"correlation": 13}},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


def test_busy_encoder_and_gaps(tmp_path):
    # the window opened at t = 5.0 s on the host's clock
    spans = [("score_pairs", (8, 7, -3), 5.00005, 5.0004),
             ("encoder_call", (8, 7, -3), 5.0001, 5.0004),
             ("bm25", (1, 2), 5.0005, 5.0008)]
    s = summarize(_trace(tmp_path), spans, 5.0, "encoder_call")
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(290e-6)        # 1110-1350, 1700-1750
    assert s["encoder_device_s"] == pytest.approx(300e-6)
    assert dict(s["device_ops"])["gemm"] == pytest.approx(200e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["score_pairs"] == pytest.approx(110e-6)   # 1000-1110
    assert gaps["bm25"] == pytest.approx(350e-6)          # 1350-1700
    assert gaps["host"] == pytest.approx(250e-6)          # 1750-2000
    assert sum(gaps.values()) == pytest.approx(1e-3 - 290e-6)


def test_no_window_is_an_error(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(RuntimeError):
        summarize(str(p), [], 0.0, "encoder_call")
