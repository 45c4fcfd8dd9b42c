"""The cross-encoder of repro_torch against the reference, from bridged
weights: ``encoder_score`` within fp32 tolerance (rtol=atol=1e-5: the two
frameworks sum in different orders), Mono rankings equal per qid, Duo
aggregates allclose."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.ir as jir
import repro.models.common as jcommon
import repro.models.cross_encoder as jce
import repro_torch.core as tcore
import repro_torch.models.common as tcommon
import repro_torch.models.cross_encoder as tce

torch.set_num_threads(1)

# A config name of its own: the reference's process-wide compile cache
# keys executables by (name, input shapes), not by weights, so another
# test's scorer of the same name and shapes would lend it its weights.
SMALL = dict(name="torch-parity-encoder", n_layers=2, d_model=32,
             n_heads=2, d_ff=64, vocab_size=2048, max_len=16)
JCFG = jce.EncoderConfig(**SMALL)
TCFG = tce.EncoderConfig(**SMALL)


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _tokens(seed, batch=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SMALL["vocab_size"] + 50,   # some ids clip
                        (batch, SMALL["max_len"])).astype(np.int32)
    lengths = rng.integers(1, SMALL["max_len"] + 1, batch)
    toks[np.arange(SMALL["max_len"])[None, :] >= lengths[:, None]] = 0
    toks[0, :] = 0                                      # all padding
    return toks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encoder_score_matches_reference(seed):
    params = jcommon.init_params(jce.encoder_param_specs(JCFG),
                                 jax.random.key(seed))
    toks = _tokens(seed)
    ref = np.asarray(jce.encoder_score(params, jnp.asarray(toks), JCFG))
    tree = tcommon.params_from_numpy(_numpy_tree(params), "cpu")
    with torch.inference_mode():
        got = tce.encoder_score(tree, torch.from_numpy(toks), TCFG).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 7, 32)).astype(np.float32)
    s = rng.normal(size=(32,)).astype(np.float32)
    ref = np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s)))
    got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_params_from_numpy_keeps_layout():
    params = _numpy_tree(jcommon.init_params(
        jce.encoder_param_specs(JCFG), jax.random.key(0)))
    tree = tcommon.params_from_numpy(params, "cpu")
    assert tree["layers"]["wq"].shape == (2, 32, 2, 16)
    assert tree["layers"]["wo"].shape == (2, 2, 16, 32)
    np.testing.assert_array_equal(tree["embed"].numpy(), params["embed"])


def test_native_init_is_seeded_and_shaped():
    specs = tce.encoder_param_specs(TCFG)
    a = tcommon.init_params(specs, torch.Generator().manual_seed(5), "cpu")
    b = tcommon.init_params(specs, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(a["layers"]["w1"], b["layers"]["w1"])
    assert a["layers"]["w1"].shape == (2, 32, 64)
    assert torch.equal(a["layers"]["ln1"], torch.ones(2, 32))
    std = float(a["layers"]["w1"].std())
    assert abs(std - (1 / 32) ** 0.5) < 0.03


def _candidates():
    corpus = jir.msmarco_like(1, 0.02)
    res = jir.InvertedIndex.build(corpus.get_corpus_iter()).bm25(
        num_results=8)(corpus.get_topics().head(6))
    res = jir.TextLoader(corpus.text_map())(res)
    return {c: res[c] for c in res.columns}


def test_mono_ranking_equal_per_qid():
    data = _candidates()
    jm = jce.MonoScorer(JCFG, seed=3)
    tm = tce.MonoScorer(TCFG, seed=3, params=_numpy_tree(jm.params),
                        device="cpu")
    a = jm(jcore.ColFrame(data))
    b = tm(tcore.ColFrame(data))
    np.testing.assert_allclose(b["score"], a["score"], rtol=1e-5, atol=1e-5)
    for (qid,), idx in a.group_indices(["qid"]).items():
        ja = a.take(idx).sort_values(["rank"])["docno"].tolist()
        bi = b.group_indices(["qid"])[(qid,)]
        tb = b.take(bi).sort_values(["rank"])["docno"].tolist()
        assert ja == tb
    assert tm.invocations == jm.invocations == len(data["qid"])


def test_duo_aggregates_allclose():
    data = _candidates()
    jd = jce.DuoScorer(JCFG, seed=4, max_docs=5)
    td = tce.DuoScorer(TCFG, seed=4, max_docs=5,
                       params=_numpy_tree(jd.params), device="cpu")
    a = jd(jcore.ColFrame(data))
    b = td(tcore.ColFrame(data))
    assert a["docno"].tolist() == b["docno"].tolist()
    np.testing.assert_allclose(b["score"], a["score"], rtol=1e-5, atol=1e-5)
    assert td.invocations == jd.invocations


def test_scorers_of_one_config_keep_their_own_weights():
    """Unlike the reference's compile cache (keyed by config name and
    shapes), each port scorer scores with its own weights."""
    toks = _tokens(5)
    scorers = [tce.MonoScorer(TCFG, seed=s, device="cpu") for s in (0, 1)]
    outs = [m._score_tokens(toks) for m in scorers]
    assert not np.allclose(outs[0], outs[1])
    for m, out in zip(scorers, outs):
        with torch.inference_mode():
            own = tce.encoder_score(m.encoder.tree, torch.from_numpy(toks),
                                    TCFG).numpy()
        np.testing.assert_array_equal(out, own)


def test_scorer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tce.MonoScorer(TCFG)
