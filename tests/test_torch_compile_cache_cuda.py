"""The CUDA-graph memo on the card: replays equal eager calls, a
dropped scorer's graph keeps its weights alive while freed memory is
reused, four threads replaying one entry each get their own results,
and a capture that fails raises.  Imports neither jax nor ``repro``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_compile_cache_cuda.py

Every test skips without a CUDA device."""
import gc
import threading

import numpy as np
import pytest
import torch

import repro_torch.caching.compile_cache as tcc
import repro_torch.models.cross_encoder as tce
from repro_torch.caching import CompileCache, pad_batch
from repro_torch.caching.bucketing import seq_bucket

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def memo(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cc = CompileCache()
    monkeypatch.setattr(tcc, "default_compile_cache", cc)
    return cc


def _pairs(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    return ([" ".join(rng.choice(words, 4)) for _ in range(n)],
            [" ".join(rng.choice(words, 20)) for _ in range(n)])


def _eager(scorer, qs, ts, bucket):
    """The encoder called eagerly on the block the runner gets: ``bucket``
    rows and the call's sequence bucket of columns."""
    toks = np.stack([scorer.tokenizer.encode_pair(
        q, t, scorer.cfg.max_len) for q, t in zip(qs, ts)])
    seq = seq_bucket(np.count_nonzero(toks, axis=1).max(), scorer.cfg.max_len)
    toks = pad_batch(np.ascontiguousarray(toks[:, :seq]), bucket)
    with torch.inference_mode():
        out = tce.encoder_score(scorer.encoder.tree,
                                torch.from_numpy(toks).cuda(), scorer.cfg)
    return out.double().cpu().numpy()[:len(qs)]


@pytest.mark.parametrize("n,bucket", [(5, 8), (100, 128), (1000, 1024)])
def test_replay_equals_eager(memo, n, bucket):
    scorer = tce.MonoScorer(tce.EncoderConfig())
    qs, ts = _pairs(n)
    first = scorer._score_pairs(qs, ts)           # miss: capture, replay
    again = scorer._score_pairs(qs, ts)           # hit: replay
    assert (memo.stats.compile_misses, memo.stats.compile_hits) == (1, 1)
    np.testing.assert_array_equal(first, again)
    np.testing.assert_allclose(first, _eager(scorer, qs, ts, bucket),
                               rtol=1e-5, atol=1e-6)


def test_a_dropped_scorers_graph_keeps_its_weights(memo):
    cfg = tce.EncoderConfig()
    qs, ts = _pairs(40, seed=1)
    a = tce.MonoScorer(cfg, seed=0)
    b = tce.MonoScorer(cfg, seed=1)
    want_a, want_b = a._score_pairs(qs, ts), b._score_pairs(qs, ts)
    del a
    gc.collect()
    torch.cuda.empty_cache()
    # fill what the allocator frees with NaN: a replay that read freed
    # memory would return NaN
    junk = [torch.full((1 << 20,), float("nan"), device="cuda")
            for _ in range(64)]
    np.testing.assert_array_equal(b._score_pairs(qs, ts), want_b)
    a2 = tce.MonoScorer(cfg, seed=0)                # hits a's entry
    np.testing.assert_array_equal(a2._score_pairs(qs, ts), want_a)
    assert memo.stats.compile_misses == 2 and len(memo.entries()) == 2
    del junk


def test_threads_replaying_one_entry_get_their_own_results(memo):
    scorer = tce.MonoScorer(tce.EncoderConfig())
    batches = [_pairs(60, seed=s) for s in range(4)]
    want = [scorer._score_pairs(*b) for b in batches]
    errors = []

    def work(i):
        try:
            for _ in range(25):
                np.testing.assert_array_equal(
                    scorer._score_pairs(*batches[i]), want[i])
        except AssertionError as e:
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert memo.stats.compile_misses == 1


def test_a_capture_that_fails_raises(memo):
    def syncs(x):
        return x * float(x.sum())              # a host read: not capturable

    with pytest.raises(RuntimeError):
        memo.call("syncs", syncs, torch.ones(8, device="cuda"))
    assert memo.entries() == []
    out = memo.call("fine", lambda x: x + 1, torch.ones(8, device="cuda"))
    assert torch.equal(out, torch.full((8,), 2.0, device="cuda"))
