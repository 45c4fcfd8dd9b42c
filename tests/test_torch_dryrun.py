"""The port's dry run on the meta device: a cell of each kind runs on the
production meshes, a 2-layer LM's FLOPs equal its L = 0 cell's plus two
single-layer probes', the MoE dispatch runs on meta with exact counts,
and the launcher keeps its process group to itself.

Cells are cut in depth (``n_layers``) to keep the tests cheap; their
widths and shapes are the published ones.  The meshes here are duck
types (``mesh_dim_names``, ``shape``), which is all ``Cell.lower``
reads: no process group is set up in the test process.  The launcher
itself runs in a subprocess."""
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import LM_SHAPES, get_arch
from repro_torch.configs.base import lm_layer_probe
from repro_torch.distrib.shardings import ShardingRules
from repro_torch.launch.roofline import NVLINK_BW
from repro_torch.models import lm as tlm
from repro_torch.models.common import abstract_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
MESHES = {"16x16": SimpleNamespace(mesh_dim_names=("data", "model"),
                                   shape=(16, 16)),
          "2x16x16": SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                     shape=(2, 16, 16))}
DEPTH = {"n_layers": 2}
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=512, vocab_pad_multiple=128)
# (arch, shape, overrides) of each kind of cell
KINDS = [("smollm-360m", "train_4k", DEPTH),
         ("smollm-360m", "prefill_32k", DEPTH),
         ("qwen3-14b", "decode_32k", DEPTH),
         ("qwen1.5-110b", "long_500k", DEPTH),
         ("granite-moe-3b-a800m", "train_4k", DEPTH),
         ("gcn-cora", "ogb_products", None),
         ("dlrm-rm2", "train_batch", None),
         ("two-tower-retrieval", "retrieval_cand", None)]


def _cell(arch, shape, overrides=None):
    a = get_arch(arch)
    if overrides and a.family == "lm":
        return a.cell(shape, cfg_overrides=overrides)
    return a.cell(shape)


@pytest.mark.parametrize("arch,shape,overrides", KINDS,
                         ids=[f"{a}-{s}" for a, s, _ in KINDS])
def test_a_cell_of_each_kind_lowers_on_meta(arch, shape, overrides):
    cell = _cell(arch, shape, overrides)
    first = None
    for name, mesh in MESHES.items():
        low = cell.lower(mesh, ShardingRules(), counted=first)
        assert low.flops > 0 and low.bytes_accessed > 0, name
        assert 0 < low.argument_bytes, name
        if first is None:
            first = low
        else:
            assert (low.flops, low.bytes_accessed) == \
                (first.flops, first.bytes_accessed)
            # twice the devices: at most as many bytes each
            assert low.argument_bytes <= first.argument_bytes


def test_the_meta_run_counts_what_a_lower_count_would():
    """A counted second mesh gives what a fresh run gives."""
    cell = _cell("granite-moe-3b-a800m", "decode_32k", DEPTH)
    a = cell.lower(MESHES["2x16x16"])
    b = cell.lower(MESHES["2x16x16"], counted=cell.lower(MESHES["16x16"]))
    assert (a.flops, a.bytes_accessed, a.argument_bytes, a.in_specs) == \
        (b.flops, b.bytes_accessed, b.argument_bytes, b.in_specs)


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_flops_equal_the_rest_plus_L_layer_probes(arch, shape):
    """FlopCounterMode counts every layer of the eager step: a 2-layer
    tiny LM's FLOPs are its 0-layer cell's plus 2 x ``lm_layer_probe``'s
    (the reference needs the probe to correct XLA's while-body count)."""
    over = dict(TINY, n_experts=4, top_k=2) \
        if get_arch(arch).config.is_moe else dict(TINY)
    mesh = MESHES["16x16"]
    full = _cell(arch, shape, over).lower(mesh).flops
    probe = lm_layer_probe(get_arch(arch), shape,
                           cfg_overrides=over).lower(mesh).flops
    if shape == "train_4k":
        rest = _head_train_flops(arch, over)
    else:
        rest = _cell(arch, shape, dict(over, n_layers=0)).lower(mesh).flops
    assert probe > 0 and full == rest + over["n_layers"] * probe


def _head_train_flops(arch, over):
    """The train step's FLOPs outside the layers: the 0-layer LM's loss
    and its gradient w.r.t. the embedding, final norm and unembedding
    (a 0-layer train cell cannot run: ``make_train_step`` refuses the
    unused layer parameters, as ``torch.autograd.grad`` does)."""
    cfg = replace(get_arch(arch).config, **dict(over, n_layers=0))
    p = abstract_params(tlm.param_specs(cfg))
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()
              if k != "layers"}
    toks = torch.empty(LM_SHAPES["train_4k"]["global_batch"],
                       LM_SHAPES["train_4k"]["seq_len"], dtype=torch.int32,
                       device="meta")
    with FlopCounterMode(display=False) as fc:
        loss = tlm.causal_lm_loss({**leaves, "layers": p["layers"]},
                                  {"tokens": toks, "labels": toks}, cfg,
                                  attention="plain")
        torch.autograd.grad(loss, list(leaves.values()))
    return fc.get_total_flops()


def test_moe_dispatch_runs_on_meta_with_exact_counts():
    """The flat dispatch counts tokens per expert with ``scatter_add_``
    (``torch.bincount`` has no meta kernel): it runs on meta, and on the
    CPU its counts are ``bincount``'s."""
    cfg = tlm.LMConfig(name="t", n_experts=8, top_k=2, dtype=torch.float32,
                       **dict(TINY, n_layers=1))
    specs = tlm.param_specs(cfg)
    p = abstract_params(specs)
    layer = {k: v[0] for k, v in p["layers"].items()}
    y, aux = tlm._moe_ffn(torch.empty(2, 16, 64, device="meta"), layer, cfg)
    assert y.device.type == "meta" and tuple(y.shape) == (2, 16, 64)
    with pytest.raises(NotImplementedError):
        torch.bincount(torch.zeros(4, dtype=torch.long, device="meta"))
    se = torch.randint(0, 8, (500,), generator=torch.Generator()
                       .manual_seed(0)).sort().values
    counts = torch.zeros(8, dtype=se.dtype).scatter_add_(
        0, se, torch.ones_like(se))
    assert torch.equal(counts, torch.bincount(se, minlength=8))
    # one_hot, stable sort and index-put, which the dispatch also uses
    assert F.one_hot(se.to("meta"), 8).shape == (500, 8)


def test_dryrun_records_and_its_process_group(tmp_path):
    """``python -m repro_torch.launch.dryrun`` writes one record per cell
    and mesh, every term derived (the collectives and the peak from the
    run on DTensor arguments, ``peak = argument + temp``), over a fake
    process group of its own; the test process never has one."""
    out = tmp_path / "d.jsonl"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gcn-cora", "--multi-pod", "both", "--out", str(out), "--quiet"],
        env=ENV, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 8
    assert {r["mesh"] for r in recs} == {"16x16", "2x16x16"}
    for r in recs:
        assert r["collective_bytes"] is not None and r["collective_s"] \
            == r["collective_bytes"] / NVLINK_BW
        assert r["collective_breakdown"]["total"] == r["collective_bytes"]
        assert r["peak_bytes"] == r["argument_bytes"] + r["temp_bytes"]
        assert r["peak_bytes"] >= r["argument_bytes"] > 0
        assert "not derived" not in r["notes"]
        terms = {t: r[f"{t}_s"] for t in ("compute", "memory", "collective")}
        assert r["dominant"] == max(terms, key=terms.get)
        assert r["est_step_s"] == max(terms.values())
        assert r["n_devices"] == (256 if r["mesh"] == "16x16" else 512)
    assert not torch.distributed.is_initialized()


def test_dryrun_jobs_write_the_records_of_one_process(tmp_path):
    """``--jobs 2`` runs the cells in two spawned processes and writes
    the records one process writes, in the same order."""
    recs = {}
    for jobs in (1, 2):
        out = tmp_path / f"d{jobs}.jsonl"
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "dlrm-rm2", "--multi-pod", "both", "--out", str(out),
             "--quiet", "--jobs", str(jobs)],
            env=ENV, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-4000:]
        recs[jobs] = [{k: v for k, v in json.loads(line).items()
                       if k != "compile_s"}
                      for line in out.read_text().splitlines()]
    assert len(recs[1]) == 8 and recs[1] == recs[2]


def test_dryrun_sets_up_its_group_in_main_only():
    """Importing the launcher sets no environment variable and sets up
    no process group; ``main`` has one while it runs and tears it down;
    a failing cell exits 1 with the failures listed."""
    script = (
        "import os, sys, torch.distributed as dist\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch.dryrun as d\n"
        "assert dict(os.environ) == before, 'environment changed'\n"
        "assert not dist.is_initialized()\n"
        "seen = []\n"
        "run = d.run_cell\n"
        "def spy(*a, **k):\n"
        "    seen.append(dist.get_world_size())\n"
        "    return run(*a, **k)\n"
        "d.run_cell = spy\n"
        "rc = d.main(['--arch', 'mind', '--shape', 'serve_p99', '--quiet',"
        " '--multi-pod', 'both'])\n"
        "print(rc, seen, dist.is_initialized())\n"
        "print(d.main(['--arch', 'mind', '--shape', 'no-such-shape',"
        " '--quiet']))\n")
    run = subprocess.run([sys.executable, "-c", script], env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.strip().splitlines()
    assert lines[-1] == "1" and "FAILURES" in run.stdout
    assert "0 [256, 512] False" in lines
