"""repro_torch.models.gcn against repro.models.gcn on the CPU in fp32,
with the reference's weights bridged: full-graph logits and loss (with
padded, label-masked nodes), the molecule regime, the sampled regime's
loss and gradients (``jax.grad``), and ``NeighborSampler`` byte-equal to
the reference's (the hop1 shape, degree-0 nodes that self-loop).

Tolerance: 1e-5, relative to the largest magnitude of the compared array
(the scatter-add and the GEMMs sum in other orders in the two
packages)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gcn_cora import CONFIG as J_CORA
from repro.models import common as JC
from repro.models import gcn as JG
from repro_torch.configs.gcn_cora import CONFIG as T_CORA
from repro_torch.models import gcn as TG

torch.set_num_threads(1)

TOL = 1e-5


def _cfgs(**kw):
    return JG.GCNConfig(**kw), TG.GCNConfig(**kw)


def _params(jcfg, tcfg, seed=0):
    jp = JC.init_params(JG.gcn_param_specs(jcfg), jax.random.key(seed))
    # he-init biases are zeros: give them values so their gradients and
    # their place in the sum are checked
    jp = {k: (v + 0.1 * jnp.arange(v.shape[0], dtype=v.dtype)
              if k.startswith("b") else v) for k, v in jp.items()}
    tp, source = TG.load_params(tcfg, params=jax.tree.map(np.asarray, jp),
                                device="cpu")
    assert source[0] == "numpy-sha256"
    return jp, tp


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _graph(N=80, E=320, d_feat=16, n_classes=4, seed=0, pad=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    feats = np.zeros((N + pad, d_feat), np.float32)
    feats[:N] = rng.normal(size=(N, d_feat))
    deg = np.ones(N + pad, np.float32)
    deg[:N] += np.bincount(dst, minlength=N)
    labels = np.full(N + pad, -1, np.int32)
    labels[:N] = rng.integers(0, n_classes, N)
    mask = (labels >= 0).astype(np.float32)
    return dict(feats=feats, src=src, dst=dst, deg=deg, labels=labels,
                label_mask=mask)


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _grads(tp, fn):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tp.items()}
    loss = fn(leaves)
    keys = sorted(leaves)
    return loss, dict(zip(keys, torch.autograd.grad(
        loss, [leaves[k] for k in keys])))


@pytest.mark.parametrize("pad", [0, 48])
def test_full_graph_logits_loss_and_gradients(pad):
    """Padded nodes (zero features, degree 1, label -1) are inert: the
    loss takes max(labels, 0) and masks them."""
    jcfg, tcfg = _cfgs(d_feat=16, d_hidden=16, n_classes=4)
    jp, tp = _params(jcfg, tcfg)
    b = _graph(pad=pad)
    want = JG.gcn_full_graph_logits(jp, *(jnp.asarray(b[k]) for k in
                                          ("feats", "src", "dst", "deg")),
                                    jcfg)
    got = TG.gcn_full_graph_logits(tp, *(torch.from_numpy(b[k]) for k in
                                         ("feats", "src", "dst", "deg")),
                                   tcfg)
    _close(got, want)
    jl, jg = jax.value_and_grad(
        lambda p: JG.gcn_full_graph_loss(p, _j(b), jcfg))(jp)
    tl, tg = _grads(tp, lambda p: TG.gcn_full_graph_loss(p, _t(b), tcfg))
    _close(tl, jl)
    for k in sorted(jp):
        _close(tg[k], jg[k])


def test_molecule_loss_and_gradients():
    jcfg, tcfg = _cfgs(d_feat=8, d_hidden=8, n_classes=3)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(1)
    G, N, E = 5, 6, 10
    b = dict(feats=rng.normal(size=(G, N, 8)).astype(np.float32),
             src=rng.integers(0, N, (G, E)).astype(np.int32),
             dst=rng.integers(0, N, (G, E)).astype(np.int32),
             deg=rng.integers(1, 4, (G, N)).astype(np.float32),
             labels=rng.integers(0, 3, G).astype(np.int32))
    jl, jg = jax.value_and_grad(
        lambda p: JG.gcn_molecule_loss(p, _j(b), jcfg))(jp)
    tl, tg = _grads(tp, lambda p: TG.gcn_molecule_loss(p, _t(b), tcfg))
    _close(tl, jl)
    for k in sorted(jp):
        _close(tg[k], jg[k])


def _sampled_batch(N=120, E=600, d=12, fanouts=(5, 3), Bn=8, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    feats = rng.normal(size=(N, d)).astype(np.float32)
    labels = rng.integers(0, 4, N).astype(np.int32)
    samp = TG.NeighborSampler.from_edges(N, src, dst)
    seeds = rng.integers(0, N, Bn).astype(np.int32)
    hops = samp.sample(seeds, fanouts, seed=11)
    f1, f2 = fanouts
    return {"feats_hop0": feats[hops["hop0"]],
            "feats_hop1": feats[hops["hop1"]],
            "feats_hop2": feats[hops["hop2"].reshape(Bn, f1, f2)],
            "labels": labels[hops["hop0"]]}


def test_sampled_loss_and_gradients():
    jcfg, tcfg = _cfgs(d_feat=12, d_hidden=16, n_classes=4, fanouts=(5, 3))
    jp, tp = _params(jcfg, tcfg)
    b = _sampled_batch()
    jl, jg = jax.value_and_grad(
        lambda p: JG.gcn_sampled_loss(p, _j(b), jcfg))(jp)
    tl, tg = _grads(tp, lambda p: TG.gcn_sampled_loss(p, _t(b), tcfg))
    _close(tl, jl)
    for k in sorted(jp):
        _close(tg[k], jg[k])


@pytest.mark.parametrize("fanouts", [(5, 3), (4,), (3, 2, 2)])
def test_neighbor_sampler_is_byte_equal(fanouts):
    """CSR arrays and every hop, dtypes and shapes included (hop1 keeps
    [B, f1]; degree-0 nodes sample themselves)."""
    rng = np.random.default_rng(2)
    N, E = 200, 900
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N - 30, E).astype(np.int32)   # 30+ isolated
    js = JG.NeighborSampler.from_edges(N, src, dst)
    ts = TG.NeighborSampler.from_edges(N, src, dst)
    for a in ("indptr", "indices"):
        x, y = getattr(js, a), getattr(ts, a)
        assert x.dtype == y.dtype and np.array_equal(x, y)
    seeds = np.concatenate([np.arange(N - 10, N), rng.integers(0, N, 22)])
    want = js.sample(seeds, fanouts, seed=7)
    got = ts.sample(seeds, fanouts, seed=7)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes()
    assert got["hop1"].shape == (len(seeds), fanouts[0])
    isolated = got["hop1"][:10]
    assert (isolated == seeds[:10, None]).all()


def test_config_matches_reference():
    for name in ("name", "n_layers", "d_feat", "d_hidden", "n_classes",
                 "aggregator", "fanouts"):
        assert getattr(T_CORA, name) == getattr(J_CORA, name)
    assert T_CORA.dtype == torch.float32
    assert set(JG.__all__) <= set(TG.__all__)
    assert TG.pad_graph(2708) == JG.pad_graph(2708) == 3072


def test_training_reduces_loss():
    """The reference's ``test_gcn_training_reduces_loss`` through the
    port's train loop."""
    from repro_torch.train import AdamWConfig, train_loop
    cfg = TG.GCNConfig(d_feat=16, d_hidden=16, n_classes=4)
    params, _ = TG.load_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    N, E = 80, 320
    labels = rng.integers(0, 4, N)
    b = dict(feats=np.eye(16, dtype=np.float32)[labels] * 2
             + rng.normal(size=(N, 16)).astype(np.float32) * 0.1,
             src=rng.integers(0, N, E).astype(np.int32),
             dst=rng.integers(0, N, E).astype(np.int32),
             labels=labels.astype(np.int32),
             label_mask=np.ones(N, np.float32))
    b["deg"] = (np.bincount(b["dst"], minlength=N) + 1).astype(np.float32)
    batch = _t(b)
    _, _, hist = train_loop(params, lambda s: batch,
                            lambda p, bb: TG.gcn_full_graph_loss(p, bb, cfg),
                            n_steps=100,
                            opt_cfg=AdamWConfig(lr=0.05, weight_decay=0.0))
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.7
