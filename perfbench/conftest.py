"""Shared pieces of the benchmark's own tests: a cell cut to a size the
CPU runs in seconds, and a run of it through the harness."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = dict(num_hidden_layers=1, hidden_size=32, num_attention_heads=2,
                  intermediate_size=64, vocab_size=1000,
                  max_position_embeddings=64, corpus_passages=3000)
TINY_TRAFFIC = {
    "table2": dict(topics_per_experiment=4, topic_pool=40, check_topics=4),
    "open_loop": dict(topic_pool=60, rate_per_s=8.0, check_requests=6,
                      warm_batches=[1, 2], drain_s=10),
}
CELLS = ["table2-cold.msv1-minilm-l6", "serve-rerank100.msv1-electra-base"]


def tiny_cell(name: str, model=None):
    from perfbench import harness
    cell = harness.load_cell(name)
    cell.config.update(TINY_MODEL if model is None else model)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["driver"]])
    return cell


def run_tiny(cell, *, seed=2**31 + 11, seconds=0.6, trace=False,
             device="cpu", control=None):
    """One run through the harness, on one CPU thread: the test workers
    share the machine with timing-sensitive tests."""
    import torch
    from perfbench import harness
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(cell, seed=seed, seconds=seconds,
                                trace=trace, device=device,
                                t_start=time.perf_counter(), control=control)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The CUDA device, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
