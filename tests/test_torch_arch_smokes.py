"""The port's architecture registry against the reference's
(``tests/test_arch_smokes.py``): the same 10 architectures and 40 cells,
the published configs, every cell constructible with meta-device
arguments, and each reduced config's smoke outputs equal to the
reference's at fp32 1e-5, with the reference's weights bridged through
``params_from_numpy`` (and its LM tokens handed over).

The reduced LMs are run twice.  With their attention projections scaled
to the fan-in of the dimensions they contract (``_conditioned``, as
``chip_smoke.conditioned`` does on the card), the port's smoke outputs
equal the reference's smoke outputs on the same weights at 1e-5.  With
the reference's own init, which draws those projections at the fan-in of
their heads axis (ROADMAP Queue C, reference item 8), the softmax
saturates and either package's fp32 outputs lie up to ~1e-4 (relative to
their largest magnitude) from the reference run in float64: there each
output of the port is held to 1e-5 of its largest magnitude plus twice
the reference's own fp32 distance from its float64 value, both from the
reference and from that float64 value."""
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.configs.base as jbase
from repro.models.common import init_params as jinit
from repro.models import gcn as jgcn
from repro.models import lm as jlm
from repro.models import recsys as jrs

from repro_torch.configs import ARCHS, all_cells
from repro_torch.configs.base import _zip_like
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

TOL = 1e-5


def test_registry_has_all_ten_archs_and_40_cells():
    assert len(ARCHS) == 10
    assert all_cells() == jconfigs.all_cells()
    assert {a.family for a in ARCHS.values()} == {"lm", "gnn", "recsys"}
    for name, arch in ARCHS.items():
        ref = jconfigs.get_arch(name)
        assert (arch.family, arch.source, arch.shape_names()) == \
            (ref.family, ref.source, ref.shape_names())


def _ref_specs(arch, small):
    return {"lm": jlm.param_specs, "gnn": jgcn.gcn_param_specs,
            "recsys": jrs.recsys_param_specs}[arch.family](small)


def _reduced_fields(cfg) -> dict:
    """A reduced config's fields, its dtype by name."""
    def name(dt):
        return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
            else np.dtype(dt).name
    return {f.name: name(v) if f.name == "dtype" else v
            for f in fields(cfg) for v in [getattr(cfg, f.name)]}


def _conditioned(params: dict, cfg) -> dict:
    """``params`` with wq, wk and wv scaled to the fan-in D and wo to
    H·hd (fp32, a copy)."""
    p = jax.tree.map(np.array, params)
    layers = p["layers"]
    for name in ("wq", "wk", "wv"):
        layers[name] = (layers[name] * np.sqrt(
            layers[name].shape[-2] / cfg.d_model)).astype(np.float32)
    layers["wo"] = (layers["wo"] / np.sqrt(cfg.n_heads)).astype(np.float32)
    return p


def _ref_lm_f64(small, params, tokens) -> dict:
    """The reference's LM smoke (``repro.configs.base._lm_smoke``'s
    ``run``) on ``params`` in float64, its router kept in fp32 as both
    models route; layers unrolled, since the scan's carry would change
    dtype under x64.  Jitted whole: one compile, not one an op."""
    cfg = replace(small, dtype=jnp.float64, scan_layers=False)

    @jax.jit
    def run(p, toks):
        logits, _ = jlm.forward(p, toks, cfg)
        loss = jlm.causal_lm_loss(p, {"tokens": toks, "labels": toks}, cfg)
        lg, cache = jlm.prefill(p, toks, cfg)
        cache = jax.tree.map(lambda c: jnp.pad(
            c, ((0, 0), (0, 0), (0, 8), (0, 0), (0, 0))), cache)
        lg2, _ = jlm.decode_one(p, cache, toks[:, -1], jnp.int64(16), cfg)
        return {"logits": logits, "loss": loss, "prefill_logits": lg,
                "decode_logits": lg2}

    with jax.enable_x64(True):
        p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                         params)
        if "router" in p["layers"]:
            p["layers"]["router"] = p["layers"]["router"].astype(
                jnp.float32)
        return {k: np.asarray(v)
                for k, v in run(p, jnp.asarray(tokens)).items()}


def _outputs(run_out: dict) -> dict:
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor)
                          else v) for k, v in run_out.items()}


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_arch_smoke_equals_reference(arch_name, monkeypatch):
    ref = jconfigs.get_arch(arch_name)
    jsmall, jrun = ref.smoke()
    want = _outputs(jrun())
    small, run = ARCHS[arch_name].smoke()
    assert _reduced_fields(small) == _reduced_fields(jsmall)
    params = jax.tree.map(np.asarray,
                          jinit(_ref_specs(ref, jsmall), jax.random.key(0)))
    kw = {}
    if ref.family == "lm":       # the reference's smoke draws these
        kw["tokens"] = np.asarray(jax.random.randint(
            jax.random.key(1), (2, 16), 0, jsmall.vocab_size))
    got = _outputs(run(params=params, device="cpu", **kw))
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(got[k]).all(), f"{arch_name}/{k}"
    if ref.family != "lm":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{arch_name}/{k}")
        return
    assert got["logits"].shape[-1] == small.padded_vocab
    exact = _ref_lm_f64(jsmall, params, kw["tokens"])
    for k in want:
        g, w, x = got[k], want[k], exact[k]
        bound = TOL * float(np.abs(w).max()) + 2 * float(np.abs(w - x).max())
        assert float(np.abs(g - w).max()) <= bound, (arch_name, k)
        assert float(np.abs(g - x).max()) <= bound, (arch_name, k)
    # the reference's own smoke on conditioned weights, against the port's
    cond = _conditioned(params, jsmall)
    monkeypatch.setattr(jbase, "init_params", lambda specs, key: cond)
    want = _outputs(jrun())
    got = _outputs(run(params=cond, device="cpu", **kw))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{arch_name}/{k} conditioned")


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_native_smoke_is_finite(arch_name):
    small, run = ARCHS[arch_name].smoke()
    for k, v in run(device="cpu").items():
        assert torch.isfinite(v).all(), f"{arch_name}/{k}"


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_cells_constructible(arch_name):
    """Every (arch × shape) builds a Cell whose abstract arguments are
    meta tensors of the reference's shapes (the port's KV cache is
    head-major: its dims 2 and 3 swapped) and dtypes."""
    arch = ARCHS[arch_name]
    for shape in arch.shape_names():
        cell = arch.cell(shape)
        jcell = jconfigs.get_arch(arch_name).cell(shape)
        assert len(cell.abstract_args) == len(cell.arg_spec_trees)
        assert cell.kind == jcell.kind
        for i, (a, j) in enumerate(zip(cell.abstract_args,
                                       jcell.abstract_args)):
            if not isinstance(a, (dict, torch.Tensor)):
                assert j.shape == (), (shape, i)      # a decode position
                continue
            if isinstance(a, dict) and set(a) == {"k", "v"}:
                a = {n: t.transpose(2, 3) for n, t in a.items()}
            for t, r in _zip_like(a, j):
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(r.shape), (shape, i)
                assert str(t.dtype).removeprefix("torch.") == \
                    str(r.dtype), (shape, i)


def test_exact_published_configs():
    g = ARCHS["granite-moe-3b-a800m"].config
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.d_ff,
            g.vocab_size, g.n_experts, g.top_k) == \
        (32, 1536, 24, 8, 512, 49155, 40, 8)
    p = ARCHS["phi3.5-moe-42b-a6.6b"].config
    assert (p.n_layers, p.d_model, p.n_experts, p.top_k) == (32, 4096, 16, 2)
    q3 = ARCHS["qwen3-14b"].config
    assert q3.qk_norm and q3.head_dim == 128 and q3.vocab_size == 151936
    s = ARCHS["smollm-360m"].config
    assert (s.n_heads, s.n_kv_heads, s.d_ff) == (15, 5, 2560)
    q1 = ARCHS["qwen1.5-110b"].config
    assert q1.qkv_bias and q1.n_layers == 80 and q1.d_ff == 49152
    for name in ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b",
                 "qwen3-14b", "smollm-360m", "qwen1.5-110b"):
        mine, ref = ARCHS[name].config, jconfigs.get_arch(name).config
        assert tlm.num_params(mine) == jlm.num_params(ref)
