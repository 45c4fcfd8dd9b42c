"""repro_torch.models.recsys against repro.models.recsys on the CPU in
fp32, with the reference's weights bridged (``load_params(params=...)``):
the four kinds at the reference smoke's shrink
(``src/repro/configs/base.py:522-537``: vocabularies <= 64, embed_dim <=
8, MLPs <= 16, hist_len 8, B 16) through ``recsys_serve``,
``recsys_train_loss`` and its gradients (``jax.grad``); ids out of range,
clipped as ``jnp.take(mode="clip")`` clips; ``embedding_bag``'s
combiners (a mask summing to 0 < Σ < 1, an all-zero mask); MIND's fixed
routing init against ``jax.random.normal``; the five configs' values.

Tolerance: 1e-5, relative to the largest magnitude of the compared
array (``_close``): the packages sum the same fp32 products in other
orders (XLA's and oneDNN's GEMMs), which moves a value of magnitude ~1
by ~1e-7."""
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dcn_v2 import CONFIG as J_DCN
from repro.configs.dlrm_rm2 import CONFIG as J_DLRM
from repro.configs.mind import CONFIG as J_MIND
from repro.configs.two_tower_retrieval import CONFIG as J_TT
from repro.models import common as JC
from repro.models import recsys as JR
from repro_torch.configs.dcn_v2 import CONFIG as T_DCN
from repro_torch.configs.dlrm_rm2 import CONFIG as T_DLRM
from repro_torch.configs.mind import CONFIG as T_MIND
from repro_torch.configs.two_tower_retrieval import CONFIG as T_TT
from repro_torch.models import _jax_threefry
from repro_torch.models import recsys as TR

torch.set_num_threads(1)

TOL = 1e-5
CONFIGS = {"dlrm": (J_DLRM, T_DLRM), "dcn": (J_DCN, T_DCN),
           "mind": (J_MIND, T_MIND), "two_tower": (J_TT, T_TT)}
B = 16


def _shrink(cfg):
    """The reference smoke's shrink (``_recsys_smoke``)."""
    e = min(cfg.embed_dim, 8)
    return replace(
        cfg, vocab_sizes=tuple(min(v, 64) for v in cfg.vocab_sizes),
        embed_dim=e,
        bot_mlp=(tuple(min(x, 16) for x in cfg.bot_mlp[:-1]) + (e,))
        if cfg.bot_mlp else (),
        top_mlp=tuple(min(x, 16) for x in cfg.top_mlp),
        deep_mlp=tuple(min(x, 16) for x in cfg.deep_mlp),
        tower_mlp=tuple(min(x, 16) for x in cfg.tower_mlp),
        item_vocab=min(cfg.item_vocab, 128),
        user_vocab=min(cfg.user_vocab, 128), hist_len=min(cfg.hist_len, 8))


def _small(kind):
    jcfg, tcfg = CONFIGS[kind]
    return _shrink(jcfg), _shrink(tcfg)


def _batch(cfg, seed=0, serve=False, lo=0, hi_pad=0):
    """A numpy batch as the reference's smoke draws it; ``hi_pad``
    widens the id range past the vocabularies (clipped ids)."""
    rng = np.random.default_rng(seed)
    if cfg.kind in ("dlrm", "dcn"):
        return {"dense": rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
                "sparse": rng.integers(lo, min(cfg.vocab_sizes) + hi_pad,
                                       (B, cfg.n_sparse)).astype(np.int32),
                "labels": rng.integers(0, 2, B).astype(np.int32)}
    if cfg.kind == "mind":
        mask = np.ones((B, cfg.hist_len), np.float32)
        mask[::3, cfg.hist_len // 2:] = 0.0          # short histories
        return {"hist_ids": rng.integers(lo, cfg.item_vocab + hi_pad,
                                         (B, cfg.hist_len)).astype(np.int32),
                "hist_mask": mask,
                "target_ids": rng.integers(lo, cfg.item_vocab + hi_pad,
                                           B).astype(np.int32)}
    b = {"user_ids": rng.integers(lo, cfg.user_vocab + hi_pad,
                                  B).astype(np.int32),
         "item_ids": rng.integers(lo, cfg.item_vocab + hi_pad,
                                  B).astype(np.int32)}
    if serve:
        b = {"user_ids": b["user_ids"][:1],
             "cand_ids": rng.integers(lo, cfg.item_vocab + hi_pad,
                                      40).astype(np.int32)}
    return b


def _params(jcfg, tcfg, seed=0):
    jp = JC.init_params(JR.recsys_param_specs(jcfg), jax.random.key(seed))
    tp, source = TR.load_params(tcfg, params=jax.tree.map(np.asarray, jp),
                                device="cpu")
    assert source[0] == "numpy-sha256"
    return jp, tp


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_serve_matches_reference(kind):
    jcfg, tcfg = _small(kind)
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(jcfg, serve=True)
    want = JR.recsys_serve(jp, _j(batch), jcfg)
    got = TR.recsys_serve(tp, _t(batch), tcfg)
    _close(got, want)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_train_loss_and_gradients_match_reference(kind):
    """``recsys_train_loss`` and every parameter's gradient against
    ``jax.value_and_grad`` of the reference."""
    jcfg, tcfg = _small(kind)
    jp, tp = _params(jcfg, tcfg, seed=1)
    batch = _batch(jcfg, seed=2)
    jl, jg = jax.value_and_grad(
        lambda p: JR.recsys_train_loss(p, _j(batch), jcfg))(jp)
    leaves = [(path, t.requires_grad_(True)) for path, t in _flat(tp)]
    tl = TR.recsys_train_loss(tp, _t(batch), tcfg)
    grads = torch.autograd.grad(tl, [t for _, t in leaves])
    _close(tl, jl)
    want = dict(_flat(jax.tree.map(np.asarray, jg)))
    assert len(grads) == len(want)
    for (path, _), g in zip(leaves, grads):
        _close(g, want[path])


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_out_of_range_ids_are_clipped(kind):
    """Ids below 0 and past the vocabulary take the first and last row,
    as ``jnp.take(mode="clip")`` does, on serve and on the loss."""
    jcfg, tcfg = _small(kind)
    jp, tp = _params(jcfg, tcfg)
    for serve in (True, False):
        batch = _batch(jcfg, seed=3, serve=serve, lo=-40, hi_pad=600)
        fn = (JR.recsys_serve, TR.recsys_serve) if serve else \
            (JR.recsys_train_loss, TR.recsys_train_loss)
        _close(fn[1](tp, _t(batch), tcfg), fn[0](jp, _j(batch), jcfg))


BAG_MASKS = {
    "none": None,
    "binary": lambda rng: rng.integers(0, 2, (6, 5)).astype(np.float32),
    "fractional": lambda rng: np.full((6, 5), 0.15, np.float32),  # Σ 0.75
    "all_zero": lambda rng: np.zeros((6, 5), np.float32),
}


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("mask", sorted(BAG_MASKS))
def test_embedding_bag_combiners(mask, combiner):
    """``mean`` divides by max(Σmask, 1), the reference's denominator:
    with 0 < Σmask < 1 that is 1 (the op's fused mean would divide by
    Σmask), and an all-zero mask gives zeros; ids past the table clip."""
    rng = np.random.default_rng(4)
    tab = rng.normal(size=(64, 8)).astype(np.float32)
    ids = rng.integers(-5, 70, (6, 5)).astype(np.int32)
    m = BAG_MASKS[mask](rng) if BAG_MASKS[mask] else None
    want = JR.embedding_bag(jnp.asarray(tab), jnp.asarray(ids),
                            None if m is None else jnp.asarray(m), combiner)
    got = TR.embedding_bag(torch.from_numpy(tab), torch.from_numpy(ids),
                           None if m is None else torch.from_numpy(m),
                           combiner)
    _close(got, want)
    if mask == "fractional" and combiner == "mean":
        s = TR.embedding_bag(torch.from_numpy(tab), torch.from_numpy(ids),
                             torch.from_numpy(m), "sum")
        assert torch.equal(got, s)               # divided by 1, not 0.75
    if mask == "all_zero":
        assert not got.any()


def test_embedding_bag_refuses_autograd_like_its_op():
    """The bag goes through ``embedding_bag_op``, which has no backward:
    a table that requires a gradient raises under grad mode and works
    under ``no_grad``."""
    tab = torch.randn(16, 4, requires_grad=True)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="embedding_bag_ref"):
        TR.embedding_bag(tab, ids, None, "mean")
    with torch.no_grad():
        assert TR.embedding_bag(tab, ids, None, "mean").shape == (2, 4)


@pytest.mark.parametrize("shape", [(1, 4, 50), (1, 4, 8), (1, 3, 7),
                                   (1, 16, 200), (2, 5, 13)])
def test_mind_routing_init_equals_jax_random_normal(shape):
    """The words equal ``jax.random.bits``'s and the values lie within 2
    float32 ulp of ``jax.random.normal(jax.random.key(17), shape)``."""
    key = jax.random.key(TR.ROUTING_SEED)
    bits = np.asarray(jax.random.bits(key, shape))
    assert np.array_equal(_jax_threefry.random_bits(TR.ROUTING_SEED, shape),
                          bits)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = _jax_threefry.normal(TR.ROUTING_SEED, shape)
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 2
    K, L = shape[1:]
    if shape[0] == 1:
        t = TR.routing_init(K, L, torch.device("cpu"))
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), got)


def test_mind_interests_distinct_and_match_reference():
    """The reference's ``test_mind_interests_distinct_and_normalized``
    config: interests differ across capsules and equal the reference's."""
    kw = dict(name="m", kind="mind", embed_dim=16, n_interests=4,
              item_vocab=512, hist_len=12)
    jcfg, tcfg = JR.RecsysConfig(**kw), TR.RecsysConfig(**kw)
    jp, tp = _params(jcfg, tcfg, seed=1)
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 512, (4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.float32)
    want = JR.mind_interests(jp, jnp.asarray(hist), jnp.asarray(mask), jcfg)
    got = TR.mind_interests(tp, torch.from_numpy(hist),
                            torch.from_numpy(mask), tcfg)
    assert got.shape == (4, 4, 16)
    _close(got, want)
    assert float((got[:, 0] - got[:, 1]).abs().max()) > 1e-4


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_configs_and_param_specs_match_reference(kind):
    """The five configs' values, and each model's parameter tree (paths,
    shapes, inits) at full width."""
    jcfg, tcfg = CONFIGS[kind]
    for f in fields(jcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.dtype == torch.float32
    js = dict(_flat(jax.tree.map(lambda s: (s.shape, s.init, s.init_scale),
                                 JR.recsys_param_specs(jcfg),
                                 is_leaf=lambda x: isinstance(
                                     x, JC.ParamSpec))))
    ts = {p: (s.shape, s.init, s.init_scale)
          for p, s in _flat(TR.recsys_param_specs(tcfg))}
    assert js == ts


def test_native_weights_draw_from_the_generator():
    jcfg, tcfg = _small("dlrm")
    a, src = TR.load_params(tcfg, seed=3, device="cpu")
    b, _ = TR.load_params(tcfg, seed=3, device="cpu")
    assert src == ("torch.Generator", 3)
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(_flat(a), _flat(b)))
    assert a["tables"]["t0"].shape == (512, 8)


def test_all_of_the_references_names_exist():
    assert set(JR.__all__) <= set(TR.__all__)
