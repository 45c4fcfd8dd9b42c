"""``examples/train_reranker_torch.py`` against the reference's training
of the same Mono encoder, on the CPU in fp32.

Three steps of the example's optimiser and schedule with the reference's
weights bridged, on the same batches, against
``repro.train.make_train_step`` over ``repro.models.cross_encoder.
encoder_score``; the training pairs tokenised byte-equal to the
reference tokenizer's; then the example end to end at ``--steps 2``, and
the trained scorer's scores equal ``encoder_score`` of the trained
weights, with a weight source of its own.

Each of the three steps starts from the reference's weights and
optimiser state, so that no difference carries into the next step.  The
loss is held to 1e-5; the gradient, leaf by leaf, to 1e-5 of its largest
magnitude plus twice the reference's own distance from its float64
gradient (``chip_smoke.grad_err``), because the encoder's saturated
attention makes its fp32 gradients through q and k differences of
nearly equal terms, which no two fp32 evaluations reproduce to 1e-5; the
step applied to one gradient in both packages to 1e-5: weights of
max(1, the leaf's largest magnitude), moments of their largest
magnitude, with no element exempted.  Each package's step on its own
gradient is not compared: AdamW divides m by sqrt(v) element by element,
so a gradient that cancelled to rounding noise moves its weight a full
lr step in whichever direction the noise points."""
import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as JC
from repro.models import cross_encoder as JCE
from repro.train import AdamWConfig as JAdamW
from repro.train import linear_warmup_cosine as j_schedule
from repro.train import make_train_step as j_make_train_step
from repro_torch.caching.provenance import set_digest_device
from repro_torch.models.common import params_from_numpy
from repro_torch.models.cross_encoder import MonoScorer, encoder_score
from repro_torch.train.loop import _step_grads

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "train_reranker_torch", ROOT / "examples" / "train_reranker_torch.py")
ex = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ex)

TOL = 1e-5
STEPS = 3
TOTAL = 300          # the schedule's horizon, the example's default
_cs_spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_cs_spec)
_cs_spec.loader.exec_module(chip_smoke)


def _jcfg():
    c = ex.SMALL
    return JCE.EncoderConfig(n_layers=c.n_layers, d_model=c.d_model,
                             n_heads=c.n_heads, d_ff=c.d_ff,
                             vocab_size=c.vocab_size, max_len=c.max_len)


@pytest.fixture(scope="module")
def setup():
    prev = set_digest_device("cpu")
    yield ex.Setup(ex.SMALL, torch.device("cpu"))
    set_digest_device(prev)


def test_pairs_tokenise_as_the_reference(setup):
    jtok = JCE.MonoScorer(_jcfg()).tokenizer
    text = setup.dataset.text_map()
    q = setup.topics["query"].tolist()[0]
    d = text[setup.dataset.docs["docno"].tolist()[3]]
    want = jtok.encode_pair(q, d, ex.SMALL.max_len)
    got = MonoScorer(ex.SMALL, device="cpu").tokenizer.encode_pair(
        q, d, ex.SMALL.max_len)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert setup.toks.shape == (len(setup.labels), ex.SMALL.max_len)
    assert setup.labels.mean() == 0.5


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def test_three_steps_match_the_reference(setup):
    jcfg = _jcfg()
    jp = JC.init_params(JCE.encoder_param_specs(jcfg), jax.random.key(0))

    def jloss(p, b):
        z = JCE.encoder_score(p, b["toks"], jcfg).astype(jnp.float32)
        y = b["y"]
        return jnp.mean(jnp.maximum(z, 0) - z * y
                        + jnp.log1p(jnp.exp(-jnp.abs(z))))

    def jmake(loss):
        return j_make_train_step(
            loss, JAdamW(lr=3e-3, weight_decay=0.01),
            lr_schedule=lambda s: j_schedule(s, warmup=ex.WARMUP,
                                             total=TOTAL))

    def jfed(g, p, o, b):
        """The reference's step applied to the gradient ``g``."""
        step, _ = jmake(lambda q, _b: sum(
            jnp.sum(x * y) for x, y in zip(jax.tree.leaves(q),
                                           jax.tree.leaves(g))))
        return step(p, o, b)[:2]

    def tmake(loss, **kw):
        return ex.train_step(loss, TOTAL, **kw)

    jstep, jinit = jmake(jloss)
    jstep = jax.jit(jstep)
    tloss = ex.loss_fn(ex.SMALL)
    jo = jinit(jp)
    for _ in range(STEPS):
        tb = setup.batch()
        jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
        jl, jg = jax.value_and_grad(jloss)(jp, jb)
        with jax.enable_x64(True):
            jx = jax.grad(jloss)(
                jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                             jp), jb)
        tl, tg = _step_grads(tloss, _bridge(jp), tb)
        assert abs(float(tl) - float(jl)) <= TOL
        err, where, _, _ = chip_smoke.grad_err(tg, _bridge(jg), _bridge(jx))
        assert err <= 1.0, (err, where)
        # the example's step from the reference's state, then both
        # packages' steps on the reference's gradient
        _, to, tm = tmake(tloss)[0](_bridge(jp), _bridge(jo), tb)
        got = chip_smoke.fed_step(torch, tmake, _bridge(jg), _bridge(jp),
                                  _bridge(jo), tb)
        want = jfed(jg, jp, jo, jb)
        for g, w, floor in ((got[0], want[0], 1.0), (got[1], want[1], 0.0)):
            err, where = chip_smoke.leaf_err(g, _bridge(w), floor)
            assert err <= TOL, (err, where)
        jp, jo, jm = jstep(jp, jo, jb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL
        assert float(tm["lr_scale"]) == float(jm["lr_scale"])
        assert int(to["adam"]["step"]) == int(jo["adam"]["step"])
    assert int(jo["adam"]["step"]) == STEPS


def test_example_end_to_end_at_two_steps():
    prev = set_digest_device("cpu")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert ex.main(["--steps", "2", "--device", "cpu"]) == 0
    finally:
        set_digest_device(prev)
    text = out.getvalue()
    assert "step    0 loss" in text and "step    1 loss" in text
    assert "bm25 >> trained-mono" in text and "nDCG@10" in text


def test_trained_scorer_scores_its_own_weights(setup):
    """A trained scorer (two steps) scores with the trained weights,
    exactly as ``encoder_score`` computes them, and names a weight
    source of its own."""
    from repro_torch.models.common import init_params
    from repro_torch.models.cross_encoder import encoder_param_specs
    params = init_params(encoder_param_specs(ex.SMALL),
                         torch.Generator().manual_seed(0), "cpu")
    trained, losses = ex.train(setup, params, 2, log=lambda s: None)
    assert len(losses) == 2 and all(np.isfinite(losses))
    scorer = MonoScorer(ex.SMALL, params=ex.to_numpy(trained), device="cpu")
    untrained = MonoScorer(ex.SMALL, device="cpu")
    assert scorer.fingerprint_extras() != untrained.fingerprint_extras()
    assert scorer.fingerprint_extras()[1] == "numpy-sha256"
    toks = setup.toks[:64]
    with torch.no_grad():
        want = encoder_score(trained, torch.from_numpy(toks), ex.SMALL)
    got = scorer._runner(toks)
    assert np.array_equal(np.asarray(got, np.float32), want.numpy())
    assert not np.array_equal(np.asarray(untrained._runner(toks)),
                              np.asarray(got))
