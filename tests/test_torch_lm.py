"""repro_torch.models.lm against repro.models.lm on the CPU in fp32, with
the reference's weights bridged (``load_params(params=...)``): forward,
causal_lm_loss, prefill and decode_one on the reference's TINY config
(``tests/test_models.py``) and its variants — the architecture flags,
the sliding window, chunked attention, both MoE dispatches with a
capacity drop under tied router probabilities — through the kernel's
entry point (``attention="flash"``, its plain version on the CPU) and
through the port's plain attention; the reference's properties;
smollm-360m's config and parameter count; the reference's init fault at
smollm-360m's widths (its attention saturates), which the port copies.
The kernel path on the card is ``chip_smoke.py``'s ``lm:`` phase."""
import importlib.util
import math
from dataclasses import fields, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smollm_360m import CONFIG as J_SMOLLM
from repro.models import common as JC
from repro.models import lm as JL
from repro_torch.configs.smollm_360m import CONFIG as T_SMOLLM
from repro_torch.models import common as TC
from repro_torch.models import lm as TL

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# fp32 on both sides: the two packages sum the same products in other
# orders (XLA's and oneDNN's GEMMs, the kernel's plain version against
# the reference's einsums), which moves a logit of magnitude ~1 by ~1e-5
# after two layers; the reference's own consistency tests allow 2e-4
ATOL = 1e-4
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=512, vocab_pad_multiple=128, remat="none")
VARIANTS = {
    "dense": {},
    "qk_norm": dict(qk_norm=True),
    "qkv_bias": dict(qkv_bias=True),
    "fuse_qkv": dict(fuse_qkv=True),
    "tie_embeddings": dict(tie_embeddings=True),
    "gqa_repeat_kv": dict(gqa_repeat_kv=True),
    "attn_window": dict(attn_window=4),
    "chunked": dict(chunked_attn_threshold=1, attn_chunk=8),
    "chunked_window": dict(chunked_attn_threshold=1, attn_chunk=8,
                           attn_window=5),
    "moe": dict(n_experts=8, top_k=2),
    "moe_grouped": dict(n_experts=8, top_k=2, dispatch_groups=2),
    "moe_drop": dict(n_experts=4, top_k=1, capacity_factor=0.3),
}


def _cfgs(**kw):
    return (JL.LMConfig(**TINY, dtype=jnp.float32, **kw),
            TL.LMConfig(**TINY, dtype=torch.float32, **kw))


def _params(jcfg, tcfg, seed=0, edit=None):
    jp = JC.init_params(JL.param_specs(jcfg), jax.random.key(seed))
    if edit is not None:
        jp = edit(jp)
    tp, source = TL.load_params(tcfg, params=jax.tree.map(np.asarray, jp),
                                device="cpu")
    assert source[0] == "numpy-sha256"
    return jp, tp


def _tokens(B=2, S=24, seed=1, high=512):
    return np.random.default_rng(seed).integers(0, high, (B, S)) \
        .astype(np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("attention", TL.ATTENTION)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_loss_match_reference(variant, attention):
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens()
    want, jaux = JL.forward(jp, jnp.asarray(toks), jcfg)
    got, taux = TL.forward(tp, torch.from_numpy(toks), tcfg,
                           attention=attention)
    assert got.shape == (2, 24, tcfg.padded_vocab)
    _close(got, want)
    assert abs(float(taux) - float(jaux)) < 1e-5
    labels = toks.copy()
    labels[:, :3] = -1                       # masked positions
    jl = JL.causal_lm_loss(jp, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)}, jcfg)
    tl = TL.causal_lm_loss(tp, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)}, tcfg,
                           attention=attention)
    assert abs(float(tl) - float(jl)) < 1e-5


@pytest.mark.parametrize("attention", TL.ATTENTION)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_match_reference(variant, attention):
    """prefill of 16 tokens, then two decode steps; logits and the cache
    (head-major in the port: one permute) against the reference's, whose
    cache is padded to the same length as its own test pads it."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens()
    n, max_len = 16, 25
    jlg, jcache = JL.prefill(jp, jnp.asarray(toks[:, :n]), jcfg)
    tlg, tcache = TL.prefill(tp, torch.from_numpy(toks[:, :n]), tcfg,
                             max_len=max_len, attention=attention)
    _close(tlg, jlg)
    assert tcache["k"].shape == (2, 2, 2, max_len, 16)
    jcache = jax.tree.map(lambda c: jnp.pad(
        c, ((0, 0), (0, 0), (0, max_len - n), (0, 0), (0, 0))), jcache)
    for pos in (n, n + 1):
        jlg, jcache = JL.decode_one(jp, jcache, jnp.asarray(toks[:, pos]),
                                    jnp.int32(pos), jcfg)
        tlg, same = TL.decode_one(tp, tcache, torch.from_numpy(toks[:, pos]),
                                  pos, tcfg, attention=attention)
        assert same is tcache                          # updated in place
        _close(tlg, jlg)
    for name in ("k", "v"):
        _close(tcache[name].permute(0, 1, 3, 2, 4), jcache[name])


@pytest.mark.parametrize("groups", [0, 2])
def test_moe_ties_and_capacity_drops_match_reference(groups):
    """A zero router gives every expert the same probability: top-k
    must break the ties toward the lower expert index, as
    ``jax.lax.top_k`` does, and the stable sort must drop the same
    tokens past capacity."""
    jcfg, tcfg = _cfgs(n_experts=4, top_k=2, capacity_factor=0.5,
                       dispatch_groups=groups)

    def zero_router(p):
        p["layers"]["router"] = jnp.zeros_like(p["layers"]["router"])
        return p

    jp, tp = _params(jcfg, tcfg, edit=zero_router)
    toks = _tokens()
    want, jaux = JL.forward(jp, jnp.asarray(toks), jcfg)
    got, taux = TL.forward(tp, torch.from_numpy(toks), tcfg)
    _close(got, want)
    assert abs(float(taux) - float(jaux)) < 1e-6
    probs = torch.full((5, 4), 0.25)
    vals, idx = TL._top_k(probs, 2)
    assert idx.tolist() == [[0, 1]] * 5
    jv, ji = jax.lax.top_k(jnp.full((5, 4), 0.25), 2)
    assert np.asarray(ji).tolist() == idx.tolist()
    # capacity: 48 tokens x 2 choices into 4 experts of moe_capacity slots
    # each, all on experts 0 and 1: most assignments drop
    T = toks.size // max(groups, 1)
    assert TL.moe_capacity(tcfg, T) == JL.moe_capacity(jcfg, T) < T


def test_bridge_keeps_dtypes_and_routers_fp32():
    jcfg = JL.LMConfig(**TINY, n_experts=4, top_k=2)          # bf16
    tcfg = TL.LMConfig(**TINY, n_experts=4, top_k=2)
    jp = JC.init_params(JL.param_specs(jcfg), jax.random.key(0))
    tp, _ = TL.load_params(tcfg, params=jax.tree.map(np.asarray, jp),
                           device="cpu")
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["w1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["embed"].float().numpy(),
        np.asarray(jp["embed"].astype(jnp.float32)))
    native, source = TL.load_params(tcfg, seed=3, device="cpu")
    assert source == ("torch.Generator", 3)
    assert native["layers"]["router"].dtype == torch.float32
    again, _ = TL.load_params(tcfg, seed=3, device="cpu")
    assert torch.equal(native["embed"], again["embed"])


def test_out_of_range_ids_are_clipped_as_the_reference_clips():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(high=512)
    toks[0, :4] = [-5, 700, 10_000, 639]       # padded vocab is 640
    want, _ = JL.forward(jp, jnp.asarray(toks), jcfg)
    got, _ = TL.forward(tp, torch.from_numpy(toks), tcfg)
    _close(got, want)


# ---- the reference's properties (tests/test_models.py), in the port ------

@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, tcfg)
    return tcfg, tp, torch.from_numpy(_tokens())


def test_causality(tiny):
    """Changing a future token must not change earlier logits."""
    cfg, p, toks = tiny
    l1, _ = TL.forward(p, toks, cfg)
    toks2 = toks.clone()
    toks2[:, -1] = (toks2[:, -1] + 1) % 512
    l2, _ = TL.forward(p, toks2, cfg)
    np.testing.assert_allclose(l1[:, :-1].numpy(), l2[:, :-1].numpy(),
                               atol=1e-5)
    assert float((l1[:, -1] - l2[:, -1]).abs().max()) > 1e-6


def test_prefill_then_decode_equals_forward(tiny):
    cfg, p, toks = tiny
    n = 16
    full, _ = TL.forward(p, toks, cfg)
    lg, cache = TL.prefill(p, toks[:, :n], cfg, max_len=toks.shape[1])
    np.testing.assert_allclose(lg.numpy(), full[:, n - 1].numpy(), atol=2e-4)
    for pos in range(n, toks.shape[1]):
        lg, cache = TL.decode_one(p, cache, toks[:, pos], pos, cfg)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(),
                                   atol=2e-4)


def test_window_limits_context(tiny):
    cfg, p, toks = tiny
    wcfg = replace(cfg, attn_window=4)
    l1, _ = TL.forward(p, toks, wcfg)
    toks2 = toks.clone()
    toks2[:, 0] = (toks2[:, 0] + 3) % 512
    l2, _ = TL.forward(p, toks2, wcfg)
    np.testing.assert_allclose(l1[:, -1].numpy(), l2[:, -1].numpy(),
                               atol=1e-5)


def test_moe_routes_and_drops_overflow():
    for kw in (dict(n_experts=8, top_k=2),
               dict(n_experts=4, top_k=1, capacity_factor=0.3)):
        jcfg, tcfg = _cfgs(**kw)
        _, tp = _params(jcfg, tcfg)
        logits, aux = TL.forward(tp, torch.from_numpy(_tokens(S=16)), tcfg)
        assert not bool(logits.isnan().any())
        assert float(aux) > 0.0                 # load-balance loss active


def test_bad_arguments_raise(tiny):
    cfg, p, toks = tiny
    with pytest.raises(ValueError, match="attention"):
        TL.forward(p, toks, cfg, attention="sdpa")
    _, cache = TL.prefill(p, toks[:, :4], cfg, max_len=4)
    with pytest.raises(ValueError, match="pos"):
        TL.decode_one(p, cache, toks[:, 4], 4, cfg)
    with pytest.raises(ValueError, match="max_len"):
        TL.prefill(p, toks, cfg, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.load_params(cfg)                    # CUDA by default, no card


# ---- smollm-360m, the shared numerics ------------------------------------

def test_smollm_config_equals_reference_field_by_field():
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for f in fields(JL.LMConfig):
        want = getattr(J_SMOLLM, f.name)
        got = getattr(T_SMOLLM, f.name)
        assert got == (dtypes[want] if f.name == "dtype" else want), f.name
    assert [f.name for f in fields(TL.LMConfig)] == \
        [f.name for f in fields(JL.LMConfig)]
    assert T_SMOLLM.head_dim == 64 and T_SMOLLM.padded_vocab == 49152


@pytest.mark.parametrize("kw", [{}, dict(n_experts=8, top_k=2),
                                dict(fuse_qkv=True, qkv_bias=True,
                                     qk_norm=True, tie_embeddings=True)])
def test_parameter_counts_equal_reference(kw):
    jcfg = replace(J_SMOLLM, **kw)
    tcfg = replace(T_SMOLLM, **kw)
    assert TL.num_params(tcfg) == JL.num_params(jcfg)
    assert TL.active_params(tcfg) == JL.active_params(jcfg)
    specs = TL.param_specs(tcfg)
    meta = TC.abstract_params(specs)
    jmeta = JC.abstract_params(JL.param_specs(jcfg))
    assert jax.tree.map(lambda a: tuple(a.shape), jmeta) == \
        jax.tree.map(lambda a: tuple(a.shape), meta)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(meta))
    assert TC.logical_axes_tree(specs) == JC.logical_axes_tree(
        JL.param_specs(jcfg))


def test_smollm_parameter_count_is_published_scale():
    n = TL.num_params(T_SMOLLM)
    assert n == JL.num_params(J_SMOLLM) and 0.30e9 <= n <= 0.45e9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_rms_norm_match_reference(dtype):
    """cos/sin in fp32, applied in the activation's dtype; rms_norm
    reduces in fp32 and scales in the activation's dtype.  In bf16 both
    packages round at the same places: equal to one bf16 rounding."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9)[None, :] + 100
    scale = rng.normal(size=(16,)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    atol = 1e-5 if dtype == "float32" else 2 ** -7 * 4
    got = TC.rope(tx, torch.from_numpy(pos), 10000.0)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(JC.rope(jx, jnp.asarray(pos), 10000.0), np.float32),
        rtol=2 ** -7 if dtype == "bfloat16" else 0, atol=atol)
    got = TC.rms_norm(tx, torch.from_numpy(scale).to(tx.dtype))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(JC.rms_norm(jx, jnp.asarray(scale, dtype)), np.float32),
        rtol=2 ** -7 if dtype == "bfloat16" else 1e-6, atol=atol)


# ---- a reference fault the port copies: the init's fan-in ----------------

@pytest.mark.parametrize("init", ["reference", "conditioned"])
def test_reference_init_saturates_attention_at_smollm_width(init):
    """The reference's init takes a spec's fan-in from its second-to-last
    axis: for wq and wk ([L, D, H or K, hd]) that is H = 15 or K = 5, not
    D = 960.  At smollm-360m's widths layer 0's attention scores then have
    a spread of ~100 and the softmax gives nearly all weight to one key,
    so bf16 rounding of the scores decides which.  The port's
    ``load_params`` draws at the same scale, so a random smollm-360m from
    it is no usable bf16 model; ``chip_smoke.conditioned`` rescales the
    projections to the fan-in they contract and brings the scores to ~1."""
    S = 128
    jcfg = replace(J_SMOLLM, n_layers=1, vocab_size=1024, dtype=jnp.float32)
    tcfg = replace(T_SMOLLM, n_layers=1, vocab_size=1024,
                   dtype=torch.float32)
    jp = JC.init_params(JL.param_specs(jcfg), jax.random.key(0))
    tp, _ = TL.load_params(tcfg, params=jax.tree.map(np.asarray, jp),
                           device="cpu")
    own, _ = TL.load_params(tcfg, seed=0, device="cpu")
    for name in ("wq", "wk", "wv", "wo"):
        assert float(own["layers"][name].std()) == pytest.approx(
            float(tp["layers"][name].std()), rel=0.02), name
    if init == "conditioned":
        chip_smoke.conditioned(tp, tcfg)
    layer = TL._layer(tp, 0)
    toks = torch.from_numpy(_tokens(B=1, S=S, high=1024))
    q, k, _ = TL._qkv(TC.rms_norm(TL._embed(tp, toks), layer["ln1"]),
                      layer, tcfg)
    pos = torch.arange(S)[None, :]
    q, k = TC.rope(q, pos, tcfg.rope_base), TC.rope(k, pos, tcfg.rope_base)
    K, hd = tcfg.n_kv_heads, tcfg.head_dim
    scores = torch.einsum("bqkgh,bskh->bkgqs",
                          q.reshape(1, S, K, tcfg.n_heads // K, hd), k) \
        / math.sqrt(hd)
    keep = TL._keep(pos[0], pos[0], None)
    top = torch.softmax(scores.masked_fill(~keep, float("-inf")), -1) \
        .amax(-1)[..., S // 2:]                # rows with >= 65 keys
    spread = float(scores[..., keep].std())
    if init == "reference":
        assert spread > 50 and float(top.median()) > 0.99, (spread, top)
    else:
        assert spread < 3 and float(top.median()) < 0.5, (spread, top)
