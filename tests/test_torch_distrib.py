"""The port's distribution layer on the CPU: four gloo ranks check
DeviceMesh placements from the sharding rules, ``activation_sharding``
redistributing a DTensor, and the elastic restore of a checkpoint saved
from a (4,) mesh onto a (2, 2) mesh, held to the reference's restore of
the same directory; and ``DenseIndex.device_chunks`` over three devices
against the reference's ``DenseIndex.topk``."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.ir as jir
from repro.distrib.checkpoint import restore_checkpoint as jrestore

import repro_torch.ir.dense as tdense
from repro_torch.configs import get_arch
from repro_torch.distrib.shardings import ShardingRules, placements_for
from repro_torch.models import lm
from repro_torch.models.common import _leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESH22 = type("Mesh", (), {"mesh_dim_names": ("data", "model"),
                           "shape": (2, 2)})()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _shard(full: np.ndarray, spec, coord) -> np.ndarray:
    """The block of ``full`` that mesh coordinate ``coord`` of the (2, 2)
    (data, model) mesh holds under ``spec``."""
    index = []
    for d, part in enumerate(tuple(spec) + (None,) * full.ndim):
        if d >= full.ndim:
            break
        axes = () if part is None else \
            (part if isinstance(part, tuple) else (part,))
        k, n = 0, 1
        for a in ("data", "model"):
            if a in axes:
                k, n = k * 2 + coord[("data", "model").index(a)], n * 2
        size = full.shape[d] // n
        index.append(slice(k * size, (k + 1) * size))
    return full[tuple(index)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    out = tmp_path_factory.mktemp("out")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_distrib_worker.py"),
         str(r), str(port), str(ckpt), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, "\n".join(logs)
    return ckpt, [torch.load(out / f"rank{r}.pt", weights_only=False)
                  for r in range(4)]


def test_placements_follow_the_rules(ranks):
    _, outs = ranks
    cfg = get_arch("smollm-360m").smoke()[0]
    specs = dict(_leaves(lm.param_specs(cfg)))
    params, _ = lm.load_params(cfg, seed=3, device="cpu")
    params["embed"] = params["embed"].to(torch.bfloat16)
    full = dict(_leaves(params))
    assert sorted(tuple(o["coord"]) for o in outs) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    sharded = 0
    for o in outs:
        for path, (pl, local) in o["placements"].items():
            spec = ShardingRules().spec_of(specs[path], MESH22)
            assert pl == tuple(str(p) for p in placements_for(spec, MESH22))
            want = _shard(full[path].float().numpy(), spec, o["coord"])
            assert np.array_equal(local.float().numpy(), want), path
            sharded += int(any(p != "R" for p in pl))
    assert sharded >= 4 * 4       # some leaves split on every rank


def test_activation_sharding_redistributes_a_dtensor(ranks):
    _, outs = ranks
    x = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
    for o in outs:
        pl, local = o["activation"]
        assert pl == ("S(0)", "R")             # batch over data
        i = o["coord"][0]
        assert np.array_equal(local.numpy(), x[4 * i:4 * (i + 1)])
        assert o["plain_passes"] and o["outside_passes"]


def test_elastic_restore_equals_the_references(ranks):
    """Saved from a (4,) mesh, restored onto (2, 2): every rank's shard
    equals the block of the reference's restore of the same checkpoint
    (bf16 included), in the leaf's dtype."""
    ckpt, outs = ranks
    cfg = get_arch("smollm-360m").smoke()[0]
    specs = dict(_leaves(lm.param_specs(cfg)))
    like = {}
    for path, s in specs.items():
        node = like
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.zeros(s.shape, np.float32)
    ref, step = jrestore(str(ckpt / "rank0"), like)
    assert step == 5
    ref = dict(_leaves(ref))
    for o in outs:
        for path, (pl, dtype, local) in o["restored"].items():
            spec = ShardingRules().spec_of(specs[path], MESH22)
            assert pl == tuple(str(p) for p in placements_for(spec, MESH22))
            assert dtype == ("torch.bfloat16" if path == ("embed",)
                             else "torch.float32")
            want = _shard(np.asarray(ref[path], np.float32), spec,
                          o["coord"])
            assert np.array_equal(local.float().numpy(), want), path


@pytest.mark.parametrize("n_rows", [300, 301])
def test_device_chunks_over_three_devices_equal_reference(n_rows,
                                                          monkeypatch):
    """Rows split over three devices (three chunks where the rows
    divide, one where the rule prunes the split) and merged on the host:
    the reference's top-k, ties across chunks included."""
    monkeypatch.setattr(tdense, "_devices",
                        lambda m: [torch.device("cpu")] * 3)
    rng = np.random.default_rng(1)
    m = rng.integers(-3, 4, size=(n_rows, 16)).astype(np.float32)
    m[200:] = m[:n_rows - 200]             # copies in other chunks: ties
    q = rng.integers(-2, 3, size=(5, 16)).astype(np.float32)
    docnos = [f"d{i}" for i in range(n_rows)]
    jidx, tidx = jir.DenseIndex(None), tdense.DenseIndex(None)
    jidx.docnos, tidx.docnos = list(docnos), list(docnos)
    jidx.matrix, tidx.matrix = m, torch.from_numpy(m)
    chunks = tidx.device_chunks()
    assert len(chunks) == (3 if n_rows % 3 == 0 else 1)
    assert [lo for lo, _ in chunks] == ([0, 100, 200] if n_rows % 3 == 0
                                        else [0])
    for k in (7, 150):
        jv, ji = jidx.topk(q, k, backend="xla")
        tv, ti = tidx.topk(torch.from_numpy(q), k)
        assert np.array_equal(ti, ji)
        assert np.array_equal(tv, jv)
