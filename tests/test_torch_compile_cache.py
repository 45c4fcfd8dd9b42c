"""repro_torch.caching.CompileCache on the CPU against
repro.caching.CompileCache: hit and miss counts call for call, the key's
weight source (two seeds of one MonoScorer config in one process get two
entries and their own scores, where the reference returns seed 0's
scores for seed 3), no disk layer, and the dense encoder's padded last
batch.  The CUDA graphs themselves are tested on the card by
``test_torch_compile_cache_cuda.py``."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.caching as jcaching
import repro.ir as jir
import repro.models.cross_encoder as jce
import repro_torch.caching.compile_cache as tcc
import repro_torch.ir as tir
import repro_torch.models.cross_encoder as tce
from repro_torch.caching import CompileCache, pad_batch, signature_of_args
from repro_torch.caching.bucketing import seq_bucket

torch.set_num_threads(1)

SMALL = dict(name="torch-parity-compile-cache", n_layers=1, d_model=32,
             n_heads=2, d_ff=64, vocab_size=2048, max_len=16)
PAIRS = [("what is a cat", "a cat is a small feline"),
         ("what is a cat", "dogs bark"),
         ("rust language", "rust is a systems programming language"),
         ("rust language", "iron oxide forms rust"),
         ("q five", "a doc"), ("q six", "another doc")]


@pytest.fixture
def fresh(monkeypatch):
    """A fresh memo in each package, in place of the process-wide ones
    (whose entries other tests' scorers share)."""
    port, ref = CompileCache(), jcaching.CompileCache()
    monkeypatch.setattr(tcc, "default_compile_cache", port)
    monkeypatch.setattr(jce, "default_compile_cache", ref)
    monkeypatch.setattr("repro.ir.dense.default_compile_cache", ref)
    return port, ref


def _counts(cc):
    return cc.stats.compile_misses, cc.stats.compile_hits


def test_reuses_entries_call_for_call_as_the_reference_does():
    """The reference's ``test_compile_cache_reuses_executables``, with
    both memos given the same calls: equal counts after every call."""
    tc, jc = CompileCache(), jcaching.CompileCache()

    def f(x):
        return x * 2 + 1

    calls = [("f", (16, 8)), ("f", (16, 8)), ("f", (32, 8)), ("g", (16, 8)),
             ("g", (16, 8)), ("f", (32, 8))]
    for name, shape in calls:
        want = jc.call(name, f, jnp.ones(shape))
        got = tc.call(name, f, torch.ones(shape))
        assert _counts(tc) == _counts(jc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _counts(tc) == (3, 3)
    assert tc.stats.disk_hits == 0 and len(tc.entries()) == 3
    assert str(tc.stats).split(" compile_time")[0] == \
        str(jc.stats).split(" compile_time")[0] == \
        "compiles=3 reuses=3 disk_hits=0"


def test_the_key_holds_literals_and_structure():
    cc = CompileCache()
    x = torch.ones(4, 3)
    cc.call("h", lambda a, scale=1: a * scale, x, scale=2)
    cc.call("h", lambda a, scale=1: a * scale, x, scale=3)
    cc.call("h", lambda a, b: a + b[0], x, (x,))
    assert _counts(cc) == (3, 0)
    sig = signature_of_args((x,), {"scale": 2})
    assert sig[0] == (("arr", (4, 3), "torch.float32"), ("lit", "2"))


def _eager(scorer):
    """The scorer's encoder called eagerly on the block the runner gets
    for PAIRS (8 rows, the call's sequence bucket of columns: the same
    shapes, so the same sums)."""
    toks = np.stack([scorer.tokenizer.encode_pair(
        q, t, scorer.cfg.max_len) for q, t in PAIRS])
    seq = seq_bucket(np.count_nonzero(toks, axis=1).max(), scorer.cfg.max_len)
    toks = pad_batch(np.ascontiguousarray(toks[:, :seq]), 8)
    with torch.inference_mode():
        return tce.encoder_score(scorer.encoder.tree, torch.from_numpy(toks),
                                 scorer.cfg).double().numpy()


def _scores(scorer):
    return scorer._score_pairs([q for q, _ in PAIRS], [t for _, t in PAIRS])


def test_two_seeds_get_two_entries_where_the_reference_shares_one(fresh):
    port, ref = fresh
    cfg = tce.EncoderConfig(**SMALL)
    s0 = tce.MonoScorer(cfg, seed=0, device="cpu")
    s3 = tce.MonoScorer(cfg, seed=3, device="cpu")
    got0, got3 = _scores(s0), _scores(s3)
    assert _counts(port) == (2, 0)          # one bucket (8) each seed
    np.testing.assert_array_equal(got0, _eager(s0)[:len(PAIRS)])
    np.testing.assert_array_equal(got3, _eager(s3)[:len(PAIRS)])
    assert np.abs(got0 - got3).max() > 1e-3
    assert np.array_equal(_scores(s3), got3) and _counts(port) == (2, 1)
    # the reference: seed 3 after seed 0 hits seed 0's executable, whose
    # weights it closes over (ROADMAP Queue C, reference item 1)
    jcfg = jce.EncoderConfig(**SMALL)
    j0, j3 = jce.MonoScorer(jcfg, seed=0), jce.MonoScorer(jcfg, seed=3)
    r0, r3 = _scores(j0), _scores(j3)
    assert _counts(ref) == (1, 1)
    np.testing.assert_array_equal(r3, r0)
    toks = jnp.asarray(np.stack([j3.tokenizer.encode_pair(q, t, 16)
                                 for q, t in PAIRS]))
    own3 = np.asarray(jce.encoder_score(j3.params, toks, jcfg))
    assert np.abs(own3 - r3).max() > 1e-3


def test_configs_sharing_a_name_get_entries_of_their_own(fresh):
    port, _ = fresh
    a = tce.MonoScorer(tce.EncoderConfig(**SMALL), device="cpu")
    b = tce.MonoScorer(tce.EncoderConfig(**{**SMALL, "d_model": 64}),
                       device="cpu")
    got_a, got_b = _scores(a), _scores(b)
    assert _counts(port) == (2, 0)
    np.testing.assert_array_equal(got_a, _eager(a)[:len(PAIRS)])
    np.testing.assert_array_equal(got_b, _eager(b)[:len(PAIRS)])


def test_buckets_are_entries(fresh):
    port, _ = fresh
    s = tce.MonoScorer(tce.EncoderConfig(**SMALL), device="cpu")
    for n in (5, 12, 3, 16, 9):               # buckets 8, 16, 8, 16, 16
        s._score_pairs(["q"] * n, [f"doc {i}" for i in range(n)])
    assert _counts(port) == (2, 3)
    assert sorted(k[1][0][0][1][0] for k, _ in port.entries()) == [8, 16]
    assert all(k[2] == "cpu" for k, _ in port.entries())


@pytest.mark.parametrize("positional", [True, False])
def test_no_disk_layer(positional, tmp_path):
    """A CUDA graph cannot be persisted: the port's memo takes no path
    (the reference's persists executables, best-effort, and makes the
    directory)."""
    path = str(tmp_path / "memo")
    args, kwargs = ((path,), {}) if positional else ((), {"path": path})
    with pytest.raises(TypeError, match="path"):
        CompileCache(*args, **kwargs)
    assert jcaching.CompileCache(*args, **kwargs) is not None
    assert CompileCache().stats.disk_hits == 0


def test_cpu_entries_serve_threads_their_own_results():
    cc = CompileCache()
    errors = []

    def work(i):
        try:
            for _ in range(50):
                x = torch.full((8, 4), float(i))
                out = cc.call("t", lambda a: a * 3, x)
                assert torch.equal(out, x * 3)
        except AssertionError as e:         # read back in the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert _counts(cc) == (1, 199)


def test_dense_encoder_pads_its_last_batch_as_the_reference_does(fresh):
    """300 texts: a batch of 256 and one of 44, padded with zero rows to
    48 on both sides; embeddings within fp32 tolerance, and the memo
    entries at the reference's shapes."""
    port, ref = fresh
    corpus = jir.msmarco_like(1, 0.05)
    texts = corpus.docs["text"].tolist()[:300]
    cfg = dict(SMALL, name="torch-parity-compile-cache-dense")
    jenc = jir.DenseEncoder(jce.EncoderConfig(**cfg), seed=7)
    tenc = tir.DenseEncoder(tce.EncoderConfig(**cfg), seed=7,
                            params=jax.tree.map(np.asarray, jenc.params),
                            device="cpu")
    want = jenc.encode(texts)
    got = tenc.encode(texts)
    assert got.shape == (300, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    shapes = sorted(k[1][0][0][1] for k, _ in port.entries())
    assert shapes == sorted(k[1][0][0][1] for k in ref._mem) \
        == [(48, 16), (256, 16)]
    assert _counts(port) == _counts(ref) == (2, 0)
    tenc.encode(texts[:5])                    # a batch of 8, a new entry
    assert _counts(port) == (3, 0)
