"""The port's sharding rules against the reference's: ``spec_for`` takes
the same decision on every leaf of the 10 architectures' parameter,
AdamW-state, KV-cache and batch specs, on the production meshes and
three elastic ones.  The reference's meshes are its tests' ``fake_mesh``
duck type (``axis_names``, ``devices.shape``); the port's rules read a
``DeviceMesh``'s ``mesh_dim_names`` and ``shape``."""
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
import repro.configs.base as jbase
from repro.distrib.shardings import ShardingRules as JRules
from repro.models.common import ParamSpec as JSpec

import repro_torch.configs as tconfigs
from repro_torch.distrib.shardings import (ShardingRules, describe_tree_shardings,
                                           placements_for, shard_bytes)
from repro_torch.models import lm as tlm
from repro_torch.models.common import ParamSpec, _leaves

torch.set_num_threads(1)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 8, 16), ("pod", "data", "model")),
          ((8, 32), ("data", "model")),
          ((2, 2), ("data", "model"))]


def fake_mesh(shape, names):
    """The reference's duck-typed mesh (tests/test_train_distrib.py)."""
    return SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))


def port_mesh(shape, names):
    return SimpleNamespace(mesh_dim_names=names, shape=shape)


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): s
            for path, s in flat}


def _unpermute(spec, order):
    """A port spec of a dim-permuted array, in the reference's order."""
    parts = list(spec) + [None] * (len(order) - len(spec))
    out = [None] * len(order)
    for dst, src in enumerate(order):
        out[dst] = parts[src]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _spec_trees(arch, shape):
    """(reference cell, port cell) of one (arch, shape)."""
    return (jconfigs.get_arch(arch).cell(shape),
            tconfigs.get_arch(arch).cell(shape))


def _compare_tree(jtree, ttree, jmesh, tmesh, what):
    jl, tl = _ref_leaves(jtree), dict(_leaves(ttree))
    assert set(jl) == set(tl), what
    jr, tr = JRules(), ShardingRules()
    for path, js in jl.items():
        ts = tl[path]
        want = tuple(jr.spec_for(js.shape, js.logical_axes, jmesh))
        got = tr.spec_of(ts, tmesh)
        if ts.resolve_order is not None:   # the head-major KV cache
            assert tuple(ts.shape[i] for i in ts.resolve_order) == \
                tuple(js.shape), (what, path)
            got = _unpermute(got, ts.resolve_order)
        else:
            assert tuple(ts.shape) == tuple(js.shape), (what, path)
        assert got == want, (what, path, got, want)


@pytest.mark.parametrize("mesh_shape,names", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_spec_for_equals_reference_on_every_leaf(arch, mesh_shape, names,
                                                 monkeypatch):
    """Parameters, AdamW state, KV caches and batches of every cell."""
    # the reference's batch rules build NamedShardings, which need a
    # real mesh: read the PartitionSpec they are given instead
    monkeypatch.setattr(jbase, "NamedSharding", lambda mesh, spec: spec)
    jmesh, tmesh = fake_mesh(mesh_shape, names), port_mesh(mesh_shape, names)
    for shape in jconfigs.get_arch(arch).shape_names():
        jcell, tcell = _spec_trees(arch, shape)
        assert len(jcell.arg_spec_trees) == len(tcell.arg_spec_trees)
        for i, (jt, tt) in enumerate(zip(jcell.arg_spec_trees,
                                          tcell.arg_spec_trees)):
            what = (arch, shape, i)
            if jt is None:
                assert tt is None, what
            elif callable(jt):
                want = jt(jmesh, JRules())
                got = tt(tmesh, ShardingRules())
                if isinstance(want, dict):
                    assert set(want) == set(got), what
                    for k in want:
                        assert got[k] == tuple(want[k]), (what, k)
                else:
                    assert got == tuple(want), what
            else:
                _compare_tree(jt, tt, jmesh, tmesh, what)


def test_cache_resolves_in_the_reference_axis_order():
    """On a model axis that divides both the KV heads and the sequence,
    the reference's ``[L, B, S, K, hd]`` cache gives the model axis to
    ``kv_seq``; the port's head-major cache does the same only because
    it resolves in the reference's order (``resolve_order``)."""
    cfg = tconfigs.get_arch("qwen3-14b").config
    spec = tlm.init_cache_specs(cfg, 8, 4096)["k"]
    mesh = port_mesh((2, 8), ("data", "model"))
    rules = ShardingRules()
    got = rules.spec_of(spec, mesh)
    assert got == (None, "data", None, "model")          # [L, B, K, S, hd]
    jspec = JRules().spec_for((40, 8, 4096, 8, 128),
                              ("layers", "batch", "kv_seq", "kv_heads",
                               "head_dim"), fake_mesh((2, 8),
                                                      ("data", "model")))
    assert _unpermute(got, spec.resolve_order) == tuple(jspec)
    # resolved first to last instead, kv_heads would take the model axis
    assert rules.spec_for(spec.shape, spec.logical_axes, mesh) == \
        (None, "data", "model")


def test_rules_basic_mapping_and_pruning():
    r = ShardingRules()
    mesh = port_mesh((16, 16), ("data", "model"))
    assert r.spec_for((49408, 960), ("vocab", "d_model"), mesh) == \
        ("model", "data")
    assert r.spec_for((32, 960, 15, 64),
                      ("layers", "d_model", "heads", "head_dim"), mesh) == \
        (None, "data")
    # MoE w1 [L, E, D, F]: E takes model, F must not reuse it
    assert r.spec_for((32, 16, 4096, 6400),
                      ("layers", "experts", "d_model", "d_ff"), mesh) == \
        (None, "model", "data")
    pod = port_mesh((2, 16, 16), ("pod", "data", "model"))
    assert r.spec_for((1024, 64), ("table_rows", "table_dim"), pod) == \
        (("data", "model"),)
    assert r.spec_for((256, 4096), ("batch", "seq"), pod) == \
        (("pod", "data"),)
    assert r.spec_for((2, 4096), ("batch", "seq"), pod) == ("pod",)
    assert ShardingRules().override(d_ff=()).spec_for(
        (960, 2560), ("d_model", "d_ff"), mesh) == ("data",)


def test_placements_and_shard_bytes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = port_mesh((2, 16, 16), ("pod", "data", "model"))
    assert placements_for(("model", "data"), mesh) == \
        (Replicate(), Shard(1), Shard(0))
    assert placements_for((("pod", "data"), None), mesh) == \
        (Shard(0), Shard(0), Replicate())
    assert placements_for((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements_for((("data", "pod"),), mesh)
    assert shard_bytes((1024, 64), 4, (("data", "model"),), mesh) == \
        1024 * 64 * 4 // 256
    assert shard_bytes((3, 5), 2, (), mesh) == 30


def test_describe_tree_shardings_prints_the_reference_lines():
    specs = tlm.param_specs(tconfigs.get_arch("smollm-360m").config)
    mesh = port_mesh((16, 16), ("data", "model"))
    lines = describe_tree_shardings(specs, mesh)
    assert len(lines) == len(_leaves(specs))
    embed = next(line for line in lines if line.startswith("embed "))
    assert embed.endswith(str(P("model", "data")))
