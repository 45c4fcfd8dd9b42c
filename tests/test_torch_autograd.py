"""The kernel ops refuse autograd, and the LM's plain attention carries
gradients equal to the reference's.

``flash_attention_op`` and ``embedding_bag_op`` have no backward (the
reference's kernels have none): under grad mode, with an input that
requires a gradient, they raise on the CPU as on the card, so the
device never changes what a call means.  Where ``causal_lm_loss`` is
differentiated, callers pass ``attention="plain"`` (chunked or plain
attention by ``cfg.chunked_attn_threshold``, the reference's choice);
its gradients, the MoE router's included, equal ``jax.grad`` of the
reference on the tiny MoE config of ``tests/test_torch_lm.py``.

Tolerance: 1e-4 on gradients, relative to the largest magnitude of each
parameter's gradient (at least 1): the forward's logits are held to 1e-4
in ``tests/test_torch_lm.py``, where XLA and oneDNN sum the same fp32
products in other orders; the embedding's gradient, which sums a row's
occurrences, reaches 11.5 here and differs by up to 2.4e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as JC
from repro.models import lm as JL
from repro_torch.kernels.embedding_bag import embedding_bag_op
from repro_torch.kernels.flash_attention import flash_attention_op
from repro_torch.models import lm as TL

torch.set_num_threads(1)

ATOL = 1e-4
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=512, vocab_pad_multiple=128, remat="none")
MOE = dict(n_experts=8, top_k=2)


def _qkv(requires):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 8, 16, generator=g) for _ in range(3))
    return [t.requires_grad_(r) for t, r in zip((q, k, v), requires)]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_attention_op_refuses_autograd(which):
    q, k, v = _qkv([i == which for i in range(3)])
    with pytest.raises(RuntimeError, match="attention='plain'"):
        flash_attention_op(q, k, v, causal=True)
    with torch.no_grad():
        out = flash_attention_op(q, k, v, causal=True)
    assert out.shape == q.shape and not out.requires_grad
    with torch.inference_mode():
        flash_attention_op(q, k, v, causal=True)


def test_flash_attention_op_without_grad_inputs_is_unchanged():
    q, k, v = _qkv([False] * 3)
    assert flash_attention_op(q, k, v, causal=True).shape == q.shape


@pytest.mark.parametrize("which", ["table", "weights"])
def test_embedding_bag_op_refuses_autograd(which):
    tab = torch.randn(10, 4, requires_grad=which == "table")
    w = torch.rand(3, 5, requires_grad=which == "weights")
    ids = torch.randint(0, 10, (3, 5), dtype=torch.int32)
    for combiner in ("sum", "mean"):
        with pytest.raises(RuntimeError, match="embedding_bag_ref"):
            embedding_bag_op(tab, ids, w, combiner=combiner)
        with torch.no_grad():
            assert embedding_bag_op(tab, ids, w,
                                    combiner=combiner).shape == (3, 4)


def _moe(**kw):
    return (JL.LMConfig(**TINY, **MOE, dtype=jnp.float32, **kw),
            TL.LMConfig(**TINY, **MOE, dtype=torch.float32, **kw))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _grads_both(jcfg, tcfg, S=16):
    jp = JC.init_params(JL.param_specs(jcfg), jax.random.key(0))
    tp, _ = TL.load_params(tcfg, params=jax.tree.map(np.asarray, jp),
                           device="cpu")
    toks = np.random.default_rng(1).integers(0, 512, (2, S)) \
        .astype(np.int32)
    labels = toks.copy()
    labels[:, :2] = -1
    jl, jg = jax.value_and_grad(lambda p: JL.causal_lm_loss(
        p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        jcfg))(jp)
    leaves = [(path, t.requires_grad_(True)) for path, t in _flat(tp)]
    tl = TL.causal_lm_loss(tp, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)}, tcfg,
                           attention="plain")
    tg = torch.autograd.grad(tl, [t for _, t in leaves])
    return (jl, dict(_flat(jax.tree.map(np.asarray, jg)))), \
        (tl, dict(zip((p for p, _ in leaves), tg)))


@pytest.mark.parametrize("variant", ["plain", "chunked"])
def test_causal_lm_loss_plain_gradients_match_jax_grad(variant):
    """Every parameter's gradient, the router's included, against
    ``jax.grad`` of the reference (the reference's
    ``test_moe_routes_and_differs_from_dense`` takes the router's);
    ``chunked`` sets the threshold to 1, so the port's chunked attention
    carries the gradient."""
    kw = dict(chunked_attn_threshold=1, attn_chunk=8) \
        if variant == "chunked" else {}
    (jl, jg), (tl, tg) = _grads_both(*_moe(**kw))
    assert abs(float(tl.detach()) - float(jl)) < 1e-5
    assert sorted(tg) == sorted(jg)
    for path, want in jg.items():
        err = float(np.abs(tg[path].numpy() - want).max())
        assert err <= ATOL * max(1.0, float(np.abs(want).max())), path
    router = tg[("layers", "router")]
    assert float(router.abs().max()) > 0.0


def test_causal_lm_loss_through_flash_refuses_gradients():
    """The default ``attention="flash"`` reaches ``flash_attention_op``,
    which raises under autograd on the CPU too."""
    _, tcfg = _moe()
    tp, _ = TL.load_params(tcfg, seed=0, device="cpu")
    leaves = [t.requires_grad_(True) for _, t in _flat(tp)]
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="attention='plain'"):
        TL.causal_lm_loss(tp, {"tokens": toks, "labels": toks}, tcfg)
    assert leaves
