"""The port's fault policy and checkpointer (``repro_torch.distrib``)
against the reference's (``repro.distrib``): ``RetryPolicy`` delays,
budgets and ``call``; ``StragglerPolicy`` verdicts; ``RestartableLoop``
with injected preemptions bit-equal to an uninterrupted run; the
checkpoint cases of ``tests/test_train_distrib.py``; and checkpoints
that either package restores from the other (bf16 included), with equal
leaf names in the manifests."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distrib as jdist
import repro_torch.distrib as tdist
from repro_torch.distrib import (Checkpointer, Preemption, RestartableLoop,
                                 RetryPolicy, StragglerPolicy, latest_step,
                                 restore_checkpoint, save_checkpoint)

torch.set_num_threads(1)

CPU = "cpu"


# -- RetryPolicy ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"max_retries": 0},
                                {"max_retries": 5, "base_delay_s": 0.01,
                                 "multiplier": 3.0, "max_delay_s": 0.5}])
def test_retry_policy_delays_and_budget_equal_reference(kw):
    t, j = RetryPolicy(**kw), jdist.RetryPolicy(**kw)
    for attempt in range(-1, 12):
        assert t.delay(attempt) == j.delay(attempt)
        assert t.allows(attempt) == j.allows(attempt)
    assert RetryPolicy().delay(0) == 0.0
    assert RetryPolicy(max_delay_s=0.1).delay(10) == 0.1


def test_retry_policy_call_retries_then_reraises():
    slept = []
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"
    pol = RetryPolicy(max_retries=3, base_delay_s=0.05)
    assert pol.call(flaky, retry_on=(OSError,), sleep=slept.append) == "ok"
    assert len(calls) == 3 and slept == [0.05, 0.1]

    def broken():
        raise OSError("down")
    slept.clear()
    with pytest.raises(OSError, match="down"):
        pol.call(broken, retry_on=(OSError,), sleep=slept.append)
    assert slept == [0.05, 0.1, 0.2]                 # 4 attempts, 3 sleeps
    with pytest.raises(KeyError):                    # not retried
        pol.call(lambda: {}["x"], retry_on=(OSError,), sleep=slept.append)


# -- StragglerPolicy ------------------------------------------------------------

def test_straggler_policy_flags_and_evicts():
    sp = StragglerPolicy(deadline_factor=2.0, evict_after=2)
    assert sp.observe(0, 1.0) == "ok"
    assert sp.observe(1, 1.05) == "ok"
    assert sp.observe(2, 5.0) == "straggle"
    assert sp.observe(3, 5.0) == "evict"
    assert sp.evicted
    # healthy steps don't poison the EWMA baseline
    assert sp._ewma < 1.5


def test_straggler_verdicts_equal_reference():
    rng = np.random.default_rng(7)
    durations = np.abs(rng.normal(1.0, 0.2, 200))
    durations[rng.choice(200, 30, replace=False)] *= 6.0
    t = StragglerPolicy(deadline_factor=2.5, evict_after=3)
    j = jdist.StragglerPolicy(deadline_factor=2.5, evict_after=3)
    for step, d in enumerate(durations.tolist()):
        assert t.observe(step, d) == j.observe(step, d)
    assert (t.flagged_steps, t.evicted, t._ewma) == \
        (j.flagged_steps, j.evicted, j._ewma)


# -- RestartableLoop --------------------------------------------------------------

def _regression():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    y = x @ torch.tensor([[1.0], [-2.0], [3.0], [0.5]])
    return x, y


def _sgd_step(x, y, lr=0.01, momentum=0.9):
    """One torch SGD-with-momentum step on a least-squares loss; the
    state is ``(params, opt_state)``."""
    def step(state, batch):
        params, opt = state
        w = params["w"].clone().requires_grad_(True)
        xb, yb = batch
        loss = torch.mean((xb @ w[:, None] - yb) ** 2)
        loss.backward()
        with torch.no_grad():
            v = momentum * opt["v"] + w.grad
            w_new = params["w"] - lr * v
        return ({"w": w_new}, {"v": v, "t": opt["t"] + 1}), \
            {"loss": loss.detach()}
    return step


def _initial_state():
    return ({"w": torch.zeros(4)},
            {"v": torch.zeros(4), "t": torch.zeros((), dtype=torch.int64)})


def test_restart_reproduces_uninterrupted_run(tmp_path):
    x, y = _regression()

    def batch_fn(s):                     # step-keyed, deterministic
        rows = torch.arange(s % 8, 64, 8)
        return x[rows], y[rows]
    step = _sgd_step(x, y)
    ref_loop = RestartableLoop(step, batch_fn,
                               Checkpointer(str(tmp_path / "a"), keep=2,
                                            device=CPU), ckpt_every=4)
    ref = ref_loop.run(_initial_state(), 17)
    loop = RestartableLoop(step, batch_fn,
                           Checkpointer(str(tmp_path / "b"), keep=2,
                                        device=CPU), ckpt_every=4)
    out = loop.run(_initial_state(), 17, fail_at={6: 0, 13: 1, 16: 2})
    assert loop.restarts == 3 and ref_loop.restarts == 0
    assert torch.equal(ref[0]["w"], out[0]["w"])            # bit-equal
    assert torch.equal(ref[1]["v"], out[1]["v"])
    assert int(out[1]["t"]) == 17
    assert out[1]["t"].dtype == torch.int64
    # the interrupted run restores steps 4, 12 and 16, so it runs steps
    # 4-5 and 12 twice: 17 + 3 step records
    steps = [m["step"] for m in loop.metrics_log]
    assert len(steps) == 20 and sorted(set(steps)) == list(range(17))
    assert [s for s in range(17) if steps.count(s) == 2] == [4, 5, 12]
    assert latest_step(str(tmp_path / "b")) == 17


def test_restart_without_a_checkpoint_starts_over(tmp_path):
    """A preemption before the first checkpoint restarts from the initial
    state.  The reference restarts at step 0 from the state the lost
    steps left (``repro/distrib/fault.py:159-161``), so its interrupted
    run differs from its uninterrupted one; the port's does not."""
    x, y = _regression()
    step = _sgd_step(x, y)
    batch_fn = lambda s: (x, y)
    ref = RestartableLoop(step, batch_fn,
                          Checkpointer(str(tmp_path / "a"), device=CPU),
                          ckpt_every=10).run(_initial_state(), 5)
    loop = RestartableLoop(step, batch_fn,
                           Checkpointer(str(tmp_path / "b"), device=CPU),
                           ckpt_every=10)
    out = loop.run(_initial_state(), 5, fail_at={3: 0})
    assert loop.restarts == 1
    assert torch.equal(ref[0]["w"], out[0]["w"])
    assert int(out[1]["t"]) == 5

    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())

    def jstep(state, batch):
        w = state["w"] - 0.01 * jax.grad(
            lambda w: jnp.mean((batch[0] @ w[:, None] - batch[1]) ** 2))(
                state["w"])
        return {"w": w}, {}
    jruns = [jdist.RestartableLoop(
        jstep, lambda s: (jx, jy),
        jdist.Checkpointer(str(tmp_path / f"j{i}")), ckpt_every=10).run(
            {"w": jnp.zeros(4)}, 5, fail_at=fail) for i, fail in
        enumerate([None, {3: 0}])]
    assert not np.array_equal(np.asarray(jruns[0]["w"]),
                              np.asarray(jruns[1]["w"]))
    loop = RestartableLoop(step, batch_fn,
                           Checkpointer(str(tmp_path / "c"), device=CPU),
                           ckpt_every=1, max_restarts=1)
    with pytest.raises(Preemption):
        loop.run(_initial_state(), 5, fail_at={2: 0, 3: 1})


# -- checkpointing ------------------------------------------------------------------

def test_checkpoint_roundtrip_and_latest(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 3, tree)
    save_checkpoint(str(tmp_path), 7,
                    {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2}})
    assert latest_step(str(tmp_path)) == 7
    like = {"a": torch.zeros(2, 3),
            "b": {"c": torch.zeros(4, dtype=torch.bfloat16)}}
    restored, step = restore_checkpoint(str(tmp_path), like, device=CPU)
    assert step == 7
    assert torch.equal(restored["a"], tree["a"] * 2)
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"] * 2)
    restored3, _ = restore_checkpoint(str(tmp_path), like, step=3,
                                      device=CPU)
    assert torch.equal(restored3["a"], tree["a"])
    with pytest.raises(ValueError, match="missing leaves"):
        restore_checkpoint(str(tmp_path), {"zz": torch.zeros(1)},
                           device=CPU)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), like, device=CPU)


def test_checkpoint_commit_is_atomic(tmp_path):
    # a stale .tmp dir from a "crashed" save must be invisible
    os.makedirs(tmp_path / ".tmp-99-123")
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    assert latest_step(str(tmp_path)) == 1
    assert sorted(os.listdir(tmp_path)) == [".tmp-99-123", "step_1"]


def test_async_checkpointer_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, device=CPU)
    tree = {"a": torch.arange(4, dtype=torch.float32)}
    for s in (1, 2, 3, 4):
        live = {"a": tree["a"] + s}
        ck.save_async(s, live)
        live["a"].add_(100.0)            # mutating after the call is safe
    ck.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4] and ck.saves == 4
    restored, step = ck.restore(tree)
    assert step == 4
    assert torch.equal(restored["a"], tree["a"] + 4)


def test_restore_places_leaves_on_the_requested_device(tmp_path):
    """In place of the reference's elastic ``shardings=``: ``device=``
    places every leaf; the default is CUDA, which raises without a
    card rather than fall back."""
    tree = {"w": torch.arange(16, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 1, tree)
    restored, _ = restore_checkpoint(str(tmp_path), tree, device=CPU)
    assert restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], tree["w"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore_checkpoint(str(tmp_path), tree)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Checkpointer(str(tmp_path)).restore(tree)


# -- across the packages ------------------------------------------------------------

def _jax_state():
    params = {"emb": jnp.arange(12, dtype=jnp.float32).reshape(3, 4) / 7,
              "layers": [{"w": jnp.full((2, 2), 0.3, jnp.bfloat16),
                          "b": jnp.array([1, -2], jnp.int32)},
                         {"w": jnp.eye(2, dtype=jnp.bfloat16) * 1.5,
                          "b": jnp.array([7, 8], jnp.int32)}]}
    opt = {"mu": jax.tree.map(lambda x: jnp.zeros_like(x, jnp.float32) + 0.25,
                              params),
           "count": jnp.array(5, jnp.int32)}
    return params, opt


def _to_torch(tree):
    def leaf(x):
        a = np.asarray(x)
        if str(a.dtype) == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, tree)


def _as_f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A ``(params, opt_state)`` checkpoint saved by
    ``repro.distrib.save_checkpoint`` (bf16 leaves included) restores in
    the port with equal values and dtypes."""
    state = _jax_state()
    jdist.save_checkpoint(str(tmp_path), 4, state)
    like = jax.tree.map(lambda t: torch.zeros_like(t), _to_torch(state))
    got, step = tdist.restore_checkpoint(str(tmp_path), like, device=CPU)
    assert step == 4
    want_leaves = jax.tree_util.tree_leaves(state)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert isinstance(g, torch.Tensor)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(_as_f64(g), _as_f64(w))
    assert isinstance(got, tuple) and isinstance(got[0]["layers"], list)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _to_torch(_jax_state())
    tdist.save_checkpoint(str(tmp_path), 9, state)
    like = jax.tree.map(jnp.zeros_like, _jax_state())
    got, step = jdist.restore_checkpoint(str(tmp_path), like)
    assert step == 9
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(state)):
        assert str(g.dtype) == str(w.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(_as_f64(g), _as_f64(w))


def test_manifests_name_leaves_as_the_reference(tmp_path):
    """Equal structures give equal manifests: leaf names (jax's paths:
    sorted dict keys, list and tuple indices), files, shapes and logical
    dtypes; a checkpoint of a bare tensor names its leaf ``leaf``."""
    jdist.save_checkpoint(str(tmp_path / "j"), 1, _jax_state())
    tdist.save_checkpoint(str(tmp_path / "t"), 1, _to_torch(_jax_state()))
    docs = {k: json.loads((tmp_path / k / "step_1" / "manifest.json")
                          .read_text()) for k in ("j", "t")}
    assert docs["t"]["leaves"] == docs["j"]["leaves"]
    assert [l["name"] for l in docs["t"]["leaves"]][:3] == \
        ["0.emb", "0.layers.0.b", "0.layers.0.w"]
    assert {l["dtype"] for l in docs["t"]["leaves"]} == \
        {"float32", "int32", "bfloat16"}
    assert docs["t"]["step"] == 1 and docs["t"]["format_version"] == 1
    tdist.save_checkpoint(str(tmp_path / "bare"), 2, torch.ones(3))
    bare = json.loads((tmp_path / "bare" / "step_2" / "manifest.json")
                      .read_text())
    assert [l["name"] for l in bare["leaves"]] == ["leaf"]
