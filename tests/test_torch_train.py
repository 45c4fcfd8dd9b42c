"""repro_torch.train and repro_torch.distrib.compression against
repro.train and repro.distrib.compression on the CPU in fp32: AdamW with
fp32 and bf16 moments, clipping, the schedules, microbatches against the
full batch, int8 and topk compression with their error feedback,
``wire_bytes``, a run saved by the reference's ``Checkpointer`` and
continued by the port; ``train_loop`` without ``jit``.

Tolerance: 1e-5 relative to the largest magnitude of the compared array,
after several steps of a small MLP, every element included: no gradient
of the MLP cancels to rounding noise, where AdamW's m/sqrt(v) would be
a ratio of noise (``test_torch_train_reranker.py`` meets that case).
bf16 moments are held to one bf16 ulp (2^-8 relative), since a 1e-7
difference before the cast can round to the neighbouring bf16 value."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distrib import Checkpointer as JCheckpointer
from repro.distrib import compression as JZ
from repro.train import loop as JLoop
from repro.train import optimizer as JO
from repro.train import schedule as JS
from repro_torch.distrib import Checkpointer as TCheckpointer
from repro_torch.distrib import compression as TZ
from repro_torch.train import loop as TLoop
from repro_torch.train import optimizer as TO
from repro_torch.train import schedule as TS

torch.set_num_threads(1)

TOL = 1e-5


def _mlp_problem(seed=0, n=64):
    rng = np.random.default_rng(seed)
    params = {"w0": rng.normal(size=(8, 16)).astype(np.float32) * 0.5,
              "b0": rng.normal(size=(16,)).astype(np.float32) * 0.1,
              "head": {"w1": rng.normal(size=(16, 1)).astype(np.float32)}}
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (np.sin(x[:, :1]) + x[:, 1:2] ** 2).astype(np.float32)
    return params, {"x": x, "y": y}


def _jloss(p, b):
    h = jax.nn.relu(b["x"] @ p["w0"] + p["b0"])
    return jnp.mean((h @ p["head"]["w1"] - b["y"]) ** 2)


def _tloss(p, b):
    h = torch.relu(b["x"] @ p["w0"] + p["b0"])
    return torch.mean((h @ p["head"]["w1"] - b["y"]) ** 2)


def _to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _run_both(steps=5, opt_kw=None, micro=1, compression=None, sched=None,
              moment="float32"):
    """The same steps through both packages' ``make_train_step``; returns
    ((jparams, jopt, jmetrics), (tparams, topt, tmetrics))."""
    opt_kw = opt_kw or dict(lr=0.01, weight_decay=0.05)
    params, batch = _mlp_problem()
    jcfg = JO.AdamWConfig(**opt_kw, moment_dtype=getattr(jnp, moment))
    tcfg = TO.AdamWConfig(**opt_kw, moment_dtype=getattr(torch, moment))
    jsched = sched[0] if sched else JS.constant
    tsched = sched[1] if sched else TS.constant
    jstep, jinit = JLoop.make_train_step(
        _jloss, jcfg, lr_schedule=jsched, microbatches=micro,
        compression=JZ.CompressionConfig(**compression) if compression
        else None)
    tstep, tinit = TLoop.make_train_step(
        _tloss, tcfg, lr_schedule=tsched, microbatches=micro,
        compression=TZ.CompressionConfig(**compression) if compression
        else None)
    jp, tp = _to_j(params), _to_t(params)
    jo, to = jinit(jp), tinit(tp)
    jb, tb = _to_j(batch), _to_t(batch)
    jstep = jax.jit(jstep)
    for _ in range(steps):
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
    return (jp, jo, jm), (tp, to, tm)


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_steps_match_reference(moment):
    (jp, jo, jm), (tp, to, tm) = _run_both(moment=moment)
    for path, want in _flat(jp):
        _close(dict(_flat(tp))[path], want)
    mom_tol = TOL if moment == "float32" else 2 ** -8
    for which in ("m", "v"):
        for path, want in _flat(jo["adam"][which]):
            got = dict(_flat(to["adam"][which]))[path]
            assert got.dtype == getattr(torch, moment)
            _close(got, want, mom_tol)
    assert to["adam"]["step"].dtype == torch.int32
    assert int(to["adam"]["step"]) == int(jo["adam"]["step"]) == 5
    for k in ("loss", "grad_norm", "lr_scale"):
        _close(tm[k], jm[k])


def test_state_tree_and_specs_match_reference():
    params, _ = _mlp_problem()
    jo = JO.adamw_init(_to_j(params))
    to = TO.adamw_init(_to_t(params))
    assert sorted(to) == sorted(jo) == ["m", "step", "v"]
    assert [p for p, _ in _flat(to["m"])] == [p for p, _ in _flat(jo["m"])]
    from repro.models.common import ParamSpec as JSpec
    from repro_torch.models.common import ParamSpec as TSpec
    js = JO.adamw_state_specs({"a": JSpec((3, 4), ("x", "y"))},
                              jnp.bfloat16)
    ts = TO.adamw_state_specs({"a": TSpec((3, 4), ("x", "y"))},
                              torch.bfloat16)
    assert ts["m"]["a"].shape == js["m"]["a"].shape
    assert ts["v"]["a"].dtype == torch.bfloat16
    assert ts["step"].dtype == torch.int32 and ts["step"].init == "zeros"


def test_grad_clipping_bounds_update_as_the_reference():
    """The reference's ``test_grad_clipping_bounds_update``, both ways."""
    jcfg = JO.AdamWConfig(lr=1.0, grad_clip=1e-6, weight_decay=0.0)
    tcfg = TO.AdamWConfig(lr=1.0, grad_clip=1e-6, weight_decay=0.0)
    jnew, _, jm = JO.adamw_update({"w": jnp.ones(3)},
                                  {"w": jnp.full(3, 1e6)},
                                  JO.adamw_init({"w": jnp.ones(3)}), jcfg)
    tp = {"w": torch.ones(3)}
    tnew, _, tm = TO.adamw_update(tp, {"w": torch.full((3,), 1e6)},
                                  TO.adamw_init(tp), tcfg)
    assert float(tm["grad_norm"]) > 1e5
    assert float((tnew["w"] - torch.ones(3)).abs().max()) < 1.1
    _close(tnew["w"], jnew["w"])
    _close(tm["grad_norm"] / 1e6, jm["grad_norm"] / 1e6)


def test_the_step_updates_in_place():
    """The step writes into the parameters and moments it is given (the
    reference returns new arrays of the same values, held above) and
    returns those tensors; the step count is a new tensor."""
    params, batch = _mlp_problem()
    step, init = TLoop.make_train_step(_tloss, TO.AdamWConfig(lr=0.02))
    p = _to_t(params)
    opt = init(p)
    kept = (p["w0"], p["head"]["w1"], opt["adam"]["m"]["w0"],
            opt["adam"]["v"]["b0"])
    before = [t.clone() for t in kept]
    p2, opt2, _ = step(p, opt, _to_t(batch))
    assert (p2["w0"], p2["head"]["w1"], opt2["adam"]["m"]["w0"],
            opt2["adam"]["v"]["b0"]) == kept
    assert all(not torch.equal(t, b) for t, b in zip(kept, before))
    assert int(opt2["adam"]["step"]) == 1 and int(opt["adam"]["step"]) == 0


SCHEDULES = [dict(warmup=10, total=100), dict(warmup=0, total=50,
                                              floor=0.0),
             dict(warmup=20, total=20), dict(warmup=5, total=300,
                                             floor=0.3)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda k: str(sorted(k.items())))
def test_schedules_match_reference(kw):
    for step in list(range(0, 40)) + [99, 100, 150, 299, 300, 400]:
        want = float(JS.linear_warmup_cosine(step, **kw))
        got = TS.linear_warmup_cosine(step, **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-6
        g2 = TS.linear_warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                     **kw)
        assert float(g2) == float(got)
    c = TS.constant(3, value=0.5)
    assert c.dtype == torch.float32 and float(c) == 0.5 == float(
        JS.constant(3, value=0.5))
    assert float(TS.linear_warmup_cosine(0, warmup=10, total=100)) == 0.0
    assert float(TS.linear_warmup_cosine(100, warmup=10, total=100)) == \
        pytest.approx(0.1)


def test_schedule_through_the_step_matches_reference():
    sched = (lambda s: JS.linear_warmup_cosine(s, warmup=3, total=6),
             lambda s: TS.linear_warmup_cosine(s, warmup=3, total=6))
    (jp, _, jm), (tp, _, tm) = _run_both(steps=6, sched=sched)
    for path, want in _flat(jp):
        _close(dict(_flat(tp))[path], want)
    _close(tm["lr_scale"], jm["lr_scale"])


def test_microbatches_equal_the_full_batch():
    """Four equal slices with fp32 accumulation give the full batch's
    step (the reference's ``test_microbatch_equals_full_batch``), and the
    reference's own four-slice step."""
    params, batch = _mlp_problem()
    cfg = TO.AdamWConfig(lr=0.01, weight_decay=0.0)
    s1, i1 = TLoop.make_train_step(_tloss, cfg)
    s4, i4 = TLoop.make_train_step(_tloss, cfg, microbatches=4)
    p1, p4 = _to_t(params), _to_t(params)
    o1, o4 = i1(p1), i4(p4)
    b = _to_t(batch)
    for _ in range(5):
        p1, o1, m1 = s1(p1, o1, b)
        p4, o4, m4 = s4(p4, o4, b)
    for (_, x), (_, y) in zip(_flat(p1), _flat(p4)):
        _close(y, x)
    _close(m4["loss"], m1["loss"])
    (jp, _, jm), (tp, _, tm) = _run_both(micro=4)
    for path, want in _flat(jp):
        _close(dict(_flat(tp))[path], want)
    _close(tm["loss"], jm["loss"])


COMPRESSIONS = [dict(method="int8"), dict(method="int8",
                                          error_feedback=False),
                dict(method="topk", topk_fraction=0.1),
                dict(method="topk", topk_fraction=0.25,
                     error_feedback=False)]


@pytest.mark.parametrize("kw", COMPRESSIONS,
                         ids=lambda k: "-".join(map(str, k.values())))
def test_compression_and_error_feedback_match_reference(kw):
    """``compress_grads`` bit for bit against the reference (its scale,
    round half to even, the k-th magnitude's ties), three rounds with
    the error feedback carried, and sent + error == target."""
    rng = np.random.default_rng(5)
    g = {"a": rng.normal(size=(37,)).astype(np.float32),
         "b": {"c": np.round(rng.normal(size=(6, 5)) * 4).astype(
             np.float32) / 4}}                       # ties and .5 steps
    jcfg, tcfg = JZ.CompressionConfig(**kw), TZ.CompressionConfig(**kw)
    je, te = JZ.init_ef_state(_to_j(g)), TZ.init_ef_state(_to_t(g))
    for r in range(3):
        gr = jax.tree.map(lambda x: x * (1 + r), g)
        js, je2 = JZ.compress_grads(_to_j(gr), je, jcfg)
        ts, te2 = TZ.compress_grads(_to_t(gr), te, tcfg)
        for path, want in _flat(js):
            got = dict(_flat(ts))[path]
            assert got.dtype == torch.float32
            assert np.array_equal(_np(got), _np(want))
            new_e = dict(_flat(te2))[path]
            assert np.array_equal(_np(new_e), _np(dict(_flat(je2))[path]))
            if kw.get("error_feedback", True):
                target = _np(dict(_flat(gr))[path]) + _np(
                    dict(_flat(te))[path])
                np.testing.assert_allclose(_np(got) + _np(new_e), target,
                                           rtol=1e-6, atol=1e-7)
            else:
                assert not _np(new_e).any()
        je, te = je2, te2
    if kw["method"] == "topk" and not kw.get("error_feedback", True):
        flat = np.concatenate([_np(v).ravel() for _, v in _flat(ts)])
        assert (flat != 0).sum() >= 1


@pytest.mark.parametrize("kw", COMPRESSIONS[::2],
                         ids=lambda k: "-".join(map(str, k.values())))
def test_compressed_training_matches_reference(kw):
    (jp, jo, _), (tp, to, _) = _run_both(compression=kw)
    for path, want in _flat(jp):
        _close(dict(_flat(tp))[path], want)
    for path, want in _flat(jo["ef"]):
        _close(dict(_flat(to["ef"]))[path], want)


def test_wire_bytes_match_reference():
    shapes = {"a": (100,), "b": {"c": (7, 4), "d": (3, 3, 3)}}
    j = jax.tree.map(lambda s: jnp.zeros(s), shapes,
                     is_leaf=lambda x: isinstance(x, tuple))
    t = jax.tree.map(lambda s: torch.zeros(s), shapes,
                     is_leaf=lambda x: isinstance(x, tuple))
    for kw in ({}, {"method": "int8"}, {"method": "topk"},
               {"method": "topk", "topk_fraction": 0.25}):
        assert TZ.wire_bytes(t, TZ.CompressionConfig(**kw)) == \
            JZ.wire_bytes(j, JZ.CompressionConfig(**kw))
    p = {"a": torch.zeros(100), "b": torch.zeros(28)}
    assert TZ.wire_bytes(p, TZ.CompressionConfig("none")) == 128 * 4
    assert TZ.wire_bytes(p, TZ.CompressionConfig("int8")) == 128
    assert TZ.wire_bytes(p, TZ.CompressionConfig(
        "topk", topk_fraction=0.25)) == 32 * 8


def test_reference_checkpoint_continued_by_the_port(tmp_path):
    """The reference trains 3 steps and saves (params, opt_state) with
    its ``Checkpointer``; the port restores that and trains 2 more steps;
    the result equals the reference's own 5 steps."""
    params, batch = _mlp_problem()
    kw = dict(lr=0.01, weight_decay=0.05)
    jstep, jinit = JLoop.make_train_step(_jloss, JO.AdamWConfig(**kw))
    tstep, tinit = TLoop.make_train_step(_tloss, TO.AdamWConfig(**kw))
    jstep = jax.jit(jstep)
    jp, jb = _to_j(params), _to_j(batch)
    jo = jinit(jp)
    ck = JCheckpointer(str(tmp_path))
    for s in range(5):
        jp, jo, _ = jstep(jp, jo, jb)
        if s == 2:
            ck.save(3, (jp, jo))
    ck.wait()
    like = (_to_t(params), tinit(_to_t(params)))
    (tp, to), step = TCheckpointer(str(tmp_path), device="cpu").restore(like)
    assert step == 3 and int(to["adam"]["step"]) == 3
    assert to["adam"]["step"].dtype == torch.int32
    tb = _to_t(batch)
    for _ in range(2):
        tp, to, _ = tstep(tp, to, tb)
    assert int(to["adam"]["step"]) == 5
    for path, want in _flat(jp):
        _close(dict(_flat(tp))[path], want)


def test_train_loop_has_no_jit_argument():
    """Eager PyTorch has nothing to compile: ``train_loop(jit=...)``
    raises where the reference takes it (a departure, on purpose)."""
    params, batch = _mlp_problem()
    b = _to_t(batch)
    with pytest.raises(TypeError, match="jit"):
        TLoop.train_loop(_to_t(params), lambda s: b, _tloss, n_steps=1,
                         jit=True)
    JLoop.train_loop(_to_j(params), lambda s: _to_j(batch), _jloss,
                     n_steps=1, jit=False)


def test_train_loop_converges_like_the_reference():
    """The reference's linear regression (``test_adamw_converges_linreg``)
    and its int8 variant."""
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    w_true = torch.tensor([1.0, -2.0, 3.0, 0.5])
    b = {"x": X, "y": X @ w_true[:, None]}

    def loss(p, bb):
        return torch.mean((bb["x"] @ p["w"][:, None] - bb["y"]) ** 2)

    p, _, hist = TLoop.train_loop({"w": torch.zeros(4)}, lambda s: b, loss,
                                  n_steps=300,
                                  opt_cfg=TO.AdamWConfig(lr=0.05,
                                                         weight_decay=0.0))
    assert torch.allclose(p["w"], w_true, atol=0.05)
    assert [h["step"] for h in hist[:3]] == [0, 10, 20]
    p8, _, _ = TLoop.train_loop(
        {"w": torch.zeros(4)}, lambda s: b, loss, n_steps=300,
        opt_cfg=TO.AdamWConfig(lr=0.05, weight_decay=0.0),
        compression=TZ.CompressionConfig("int8"))
    assert torch.allclose(p8["w"], w_true, atol=0.1)


def test_an_unused_parameter_raises():
    """Gradients come from ``torch.autograd.grad`` without
    ``allow_unused``: a parameter the loss never reaches raises (the
    reference's ``jax.grad`` returns zeros for it)."""
    params, batch = _mlp_problem()
    p = _to_t(params)
    p["unused"] = torch.zeros(3)
    step, init = TLoop.make_train_step(_tloss, TO.AdamWConfig())
    with pytest.raises(RuntimeError, match="not have been used"):
        step(p, init(p), _to_t(batch))
