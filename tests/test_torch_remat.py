"""The LM's ``remat``, held to the reference's.

``"full"``, ``"dots"`` and ``"none"`` change what a training step saves
for its backward pass, not what it computes: a reduced LM (2 layers,
the reference's weights bridged) gives the gradients of ``jax.grad`` of
the reference under the same ``remat``, on the plain and the chunked
attention, and the three modes give the port the same gradients.  The
peak bytes of the step, counted on the meta device by
``launch.roofline.OpCounter``, fall under ``"full"``; prefill and decode
do not depend on ``remat``.

Tolerance: as ``tests/test_torch_autograd.py`` (1e-4 of each parameter
gradient's largest magnitude, at least 1; XLA and oneDNN sum the same
fp32 products in other orders).  Between the port's own modes the
recomputed forward is the forward: the gradients are equal bit for bit."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import common as JC
from repro.models import lm as JL
from repro_torch.configs import LM_SHAPES, get_arch
from repro_torch.configs.base import lm_layer_probe
from repro_torch.launch.roofline import OpCounter
from repro_torch.models import lm as TL
from repro_torch.models.common import abstract_params
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, adamw_state_specs

torch.set_num_threads(1)

ATOL = 1e-4
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=512, vocab_pad_multiple=128)
MOE = dict(n_experts=8, top_k=2)
CHUNKED = dict(chunked_attn_threshold=1, attn_chunk=8)
REMATS = ("none", "full", "dots")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _batch(S=16):
    toks = np.random.default_rng(1).integers(0, 512, (2, S)).astype(np.int32)
    labels = toks.copy()
    labels[:, :2] = -1
    return toks, labels


def _ref_grads(jcfg):
    jp = JC.init_params(JL.param_specs(jcfg), jax.random.key(0))
    toks, labels = _batch()
    _, jg = jax.value_and_grad(lambda p: JL.causal_lm_loss(
        p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        jcfg))(jp)
    return jax.tree.map(np.asarray, jp), dict(_flat(jax.tree.map(
        np.asarray, jg)))


def _port_grads(tcfg, params):
    tp, _ = TL.load_params(tcfg, params=params, device="cpu")
    toks, labels = _batch()
    leaves = [(path, t.requires_grad_(True)) for path, t in _flat(tp)]
    loss = TL.causal_lm_loss(tp, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)}, tcfg,
                             attention="plain")
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss.detach(), dict(zip((p for p, _ in leaves), grads))


def _cfgs(remat, **kw):
    return (JL.LMConfig(**TINY, dtype=jnp.float32, remat=remat, **kw),
            TL.LMConfig(**TINY, dtype=torch.float32, remat=remat, **kw))


@pytest.mark.parametrize("attn", ["plain", "chunked"])
@pytest.mark.parametrize("remat", REMATS)
def test_gradients_equal_jax_grad_under_the_same_remat(remat, attn):
    """Every gradient (the MoE router's included) against the
    reference's ``jax.grad`` under the same ``remat``; ``chunked`` puts
    the gradient through the chunked attention, whose chunk body both
    packages rematerialise."""
    jcfg, tcfg = _cfgs(remat, **MOE, **(CHUNKED if attn == "chunked"
                                         else {}))
    params, want = _ref_grads(jcfg)
    _, got = _port_grads(tcfg, params)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        err = float(np.abs(got[path].numpy() - w).max())
        assert err <= ATOL * max(1.0, float(np.abs(w).max())), (path, err)


@pytest.mark.parametrize("attn", ["plain", "chunked"])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_the_three_modes_give_equal_gradients(moe, attn):
    extra = dict(MOE if moe else {}, **(CHUNKED if attn == "chunked"
                                        else {}))
    jcfg, _ = _cfgs("none", **extra)
    params, _ = _ref_grads(jcfg)
    runs = {r: _port_grads(_cfgs(r, **extra)[1], params) for r in REMATS}
    loss0, g0 = runs["none"]
    for r in ("full", "dots"):
        loss, g = runs[r]
        assert torch.equal(loss, loss0), r
        for path, t in g0.items():
            assert torch.equal(g[path], t), (r, path)


def _train_peak(remat, moe=False, **kw):
    """The peak bytes of live storage of one train step (params, AdamW
    state and batch resident) on the meta device."""
    cfg = TL.LMConfig(**dict(TINY, n_layers=4, d_model=128, d_ff=256),
                      dtype=torch.float32, remat=remat,
                      **(MOE if moe else {}), **kw)
    specs = TL.param_specs(cfg)
    params = abstract_params(specs)
    opt = abstract_params({"adam": adamw_state_specs(specs)})
    toks = torch.empty(4, 256, dtype=torch.int32, device="meta")
    batch = {"tokens": toks, "labels": toks}
    step, _ = make_train_step(
        lambda p, b: TL.causal_lm_loss(p, b, cfg, attention="plain"),
        AdamWConfig())
    with OpCounter((params, opt, batch)) as c:
        step(params, opt, batch)
    return c.peak


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_full_remat_lowers_the_train_peak(moe):
    """The step saves each layer's input under ``"full"``, the products
    without batch dims too under ``"dots"``, every activation under
    ``"none"``."""
    peaks = {r: _train_peak(r, moe) for r in REMATS}
    assert peaks["full"] < peaks["dots"] < peaks["none"], peaks


def test_the_chunk_body_is_rematerialised_whatever_remat_says():
    """As the reference's ``jax.checkpoint`` of the chunk body: the
    chunked attention's peak does not hold a score block per chunk."""
    chunked = _train_peak("none", chunked_attn_threshold=1, attn_chunk=32)
    saved = _train_peak("none", chunked_attn_threshold=1 << 20)
    assert chunked < saved


def test_prefill_and_decode_do_not_depend_on_remat():
    base = TL.LMConfig(**TINY, dtype=torch.float32, remat="none")
    p, _ = TL.load_params(base, seed=0, device="cpu")
    for t in p["layers"].values():
        t.requires_grad_(True)
    toks = torch.from_numpy(_batch()[0])
    outs = []
    for r in REMATS:
        cfg = replace(base, remat=r)
        lg, cache = TL.prefill(p, toks, cfg, max_len=20, attention="plain")
        lg2, _ = TL.decode_one(p, cache, toks[:, -1], 16, cfg,
                               attention="plain")
        outs.append((lg.detach(), lg2.detach()))
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


def test_an_unknown_remat_raises():
    cfg = TL.LMConfig(**TINY, dtype=torch.float32, remat="some")
    p, _ = TL.load_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        TL.forward(p, torch.zeros(1, 4, dtype=torch.int32), cfg,
                   attention="plain")


@pytest.mark.parametrize("name", ["smollm-360m", "qwen3-14b",
                                  "qwen1.5-110b", "granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_configs_train_with_full_remat_as_the_reference(name):
    assert get_arch(name).config.remat == ref_arch(name).config.remat \
        == "full"


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_the_train_probe_follows_remat(remat):
    """A train cell's FLOPs are its 0-layer part's plus L x the probe's
    under every ``remat`` (recomputation counted on both sides), and
    ``"full"``'s probe recomputes its layer's forward."""
    mesh = type("M", (), {"mesh_dim_names": ("data", "model"),
                          "shape": (16, 16)})()
    over = dict(TINY, remat=remat)
    arch = get_arch("smollm-360m")
    probe = lm_layer_probe(arch, "train_4k", cfg_overrides=over) \
        .lower(mesh).flops
    full = lm_layer_probe(arch, "train_4k",
                          cfg_overrides=dict(over, remat="full")) \
        .lower(mesh).flops
    assert full > probe
    cell = arch.cell("train_4k", cfg_overrides=over).lower(mesh).flops
    head = _head_flops(arch, over)
    assert cell == head + over["n_layers"] * probe


def _head_flops(arch, over):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = replace(arch.config, **dict(over, n_layers=0))
    p = abstract_params(TL.param_specs(cfg))
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()
              if k != "layers"}
    sh = LM_SHAPES["train_4k"]
    toks = torch.empty(sh["global_batch"], sh["seq_len"], dtype=torch.int32,
                       device="meta")
    with FlopCounterMode(display=False) as fc:
        loss = TL.causal_lm_loss({**leaves, "layers": p["layers"]},
                                 {"tokens": toks, "labels": toks}, cfg,
                                 attention="plain")
        torch.autograd.grad(loss, list(leaves.values()))
    return fc.get_total_flops()
