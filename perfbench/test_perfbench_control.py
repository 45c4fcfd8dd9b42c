"""The lower-precision control on the card: the program run with TF32
matrix products allowed has to come out not correct, and the same run
with TF32 off correct.  At the configurations' own widths, on a corpus
and a window cut to what a test run holds:

    python -m pytest -q -m cuda perfbench/test_perfbench_control.py

Every test skips without a CUDA device."""
import gc

import pytest

from perfbench.conftest import run_tiny, tiny_cell

pytestmark = pytest.mark.cuda

SMALL = {"corpus_passages": 20000}


@pytest.fixture
def graphs(card, monkeypatch):
    """A CUDA-graph memo of the test's own: graphs captured by an earlier
    run (with TF32 off) are not replayed, and their pools are freed."""
    import torch
    import repro_torch.caching.compile_cache as cc
    monkeypatch.setattr(cc, "default_compile_cache", cc.CompileCache())
    yield card
    monkeypatch.undo()
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.parametrize("cell", ["table2-cold.msv1-minilm-l6",
                                  "serve-rerank100.msv1-electra-base"])
@pytest.mark.parametrize("control", [None, "tf32"])
def test_tf32_control_fails_and_float32_passes(graphs, cell, control):
    c = tiny_cell(cell, model=SMALL)
    if c.traffic["driver"] == "open_loop":
        c.traffic.update(rate_per_s=2.0, warm_batches=[1, 2, 4, 8])
    out = run_tiny(c, seconds=3.0, device=graphs, control=control)
    assert out["correct"] == (control is None), out["checks"]
