"""The dry run's per-device terms: collectives and peak bytes.

The collectives are the ``c10d_functional`` collectives DTensor issues
when a cell runs on DTensor arguments (meta local shards) on a mesh over
a ``"fake"`` process group, booked as the reference's
``parse_collective_bytes`` books XLA's: result bytes per device by op
type.  Against the reference (a subprocess, ``tests/_torch_dryrun_ref.py``,
on 8 host devices; it never imports ``repro.launch.dryrun``):

* the column-then-row two-matmul block: the same op type and bytes;
* smollm-360m ``train_4k`` at 1 layer and dlrm-rm2 ``serve_p99``: the
  totals within the factors that ``PERF.md`` states (``FACTOR``):
  DTensor picks its own redistributions (all-to-alls in the loss's
  backward, a gather where XLA pads 15 heads to 16), where XLA picks
  its own.

The counting rules: an all-to-all is booked as one all-to-all, whatever
a ``"cpu"`` mesh runs; a dim split over two mesh axes is gathered in one
all-gather per axis, each booked; an LM cell's terms at L layers are its
runs at 2 and 3 layers extrapolated: the peak of the full run at 4,
its collectives to 1e-3 (DTensor's redistributions of the stacked
parameters' gradients depend on L's divisibility).  The
peak: on a 1x1 mesh the DTensor run's equals the plain run's; on a
(2, 4) mesh the block's is the local bytes counted by hand; on real CPU
tensors it is the meta run's.

Each test sets up its own fake process group and tears it down."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import get_arch
from repro_torch.configs.base import Cell, lm_device_terms
from repro_torch.distrib.shardings import ShardingRules
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import DeviceCounter, OpCounter
from repro_torch.models import lm as TL
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
REF_CELLS = ("smollm-360m:train_4k", "dlrm-rm2:serve_p99")
#: port total / reference total, at most this far from 1 (PERF.md §6)
FACTOR = {"smollm-360m:train_4k": 8.0, "dlrm-rm2:serve_p99": 2.0}
B, D, F = 64, 256, 512        # the block's, as tests/_torch_dryrun_ref.py
#: an LM's extrapolated collectives against its full run at 4 layers,
#: each op's bytes to this share of the total
COLL_REL = 1e-3
TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
            vocab_pad_multiple=128)


class _Mesh:
    """A fake process group of ``shape``'s size and a ``"cpu"`` mesh."""

    def __init__(self, shape):
        self.shape = shape

    def __enter__(self):
        n = 1
        for s in self.shape:
            n *= s
        self._pg = fake_process_group(n)
        self._pg.__enter__()
        return make_mesh(self.shape, ("data", "model")[-len(self.shape):],
                         device_type="cpu")

    def __exit__(self, *exc):
        return self._pg.__exit__(*exc)


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _block() -> Cell:
    return Cell("block", "block", "serve", lambda x, w1, w2: (x @ w1) @ w2,
                (_meta(B, D), _meta(D, F), _meta(F, D)),
                (lambda m, r: ("data",), lambda m, r: (None, "model"),
                 lambda m, r: ("model",)),
                out_spec_trees=(lambda m, r: ("data",),))


def _cell(name, **over):
    arch, shape = name.split(":")
    a = get_arch(arch)
    return a.cell(shape, cfg_overrides=over) if a.family == "lm" \
        else a.cell(shape)


@pytest.fixture(scope="module")
def reference():
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_ref.py"),
         *REF_CELLS], env=ENV, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_the_block_books_the_references_collectives(reference):
    """x over "data", w1's columns and w2's rows over "model": one
    all-reduce of the [B/2, D] result, as XLA's HLO has it."""
    with _Mesh((2, 4)) as mesh:
        low = _block().lower(mesh)
    assert low.collectives == reference["block"] == \
        {"all-reduce": B // 2 * D * 4, "total": B // 2 * D * 4}


@pytest.mark.parametrize("name", REF_CELLS)
def test_cells_against_the_reference_within_the_stated_factor(reference,
                                                              name):
    with _Mesh((2, 4)) as mesh:
        over = {"n_layers": 1} if name.startswith("smollm") else {}
        low = _cell(name, **over).lower(mesh)
    want, got = reference[name], low.collectives
    assert want["total"] > 0 and got["total"] == sum(
        v for k, v in got.items() if k != "total")
    ratio = got["total"] / want["total"]
    assert 1 / FACTOR[name] <= ratio <= FACTOR[name], (got, want)


def test_an_all_to_all_is_booked_as_one():
    """Shard(0) -> Shard(1) on a "cpu" mesh: DTensor runs an all-gather
    and a chunk; the booking is one all-to-all of its result."""
    with _Mesh((2, 4)) as mesh:
        x = DTensor.from_local(_meta(2, 8), mesh, (Replicate(), Shard(0)),
                               run_check=False, shape=(8, 8), stride=(8, 1))
        with DeviceCounter() as c:
            y = x.redistribute(mesh, (Replicate(), Shard(1)))
    assert tuple(y.to_local().shape) == (8, 2)
    assert c.collectives == {"all-to-all": 8 * 2 * 4, "total": 8 * 2 * 4}


def test_a_joint_split_is_gathered_once_per_axis():
    """A dim split over ("data", "model") and gathered: DTensor issues
    one all-gather per mesh axis (model, then data), and each is booked
    at its result (4 then 8 local shards); XLA's one all-gather over the
    flattened group books 8."""
    with _Mesh((2, 4)) as mesh:
        x = DTensor.from_local(_meta(2, 8), mesh, (Shard(0), Shard(0)),
                               run_check=False, shape=(16, 8), stride=(8, 1))
        with DeviceCounter() as c:
            x.redistribute(mesh, (Replicate(), Replicate()))
    local = 2 * 8 * 4
    assert c.collectives == {"all-gather": (4 + 8) * local,
                             "total": (4 + 8) * local}


@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", "train_4k"), ("smollm-360m", "prefill_32k"),
    ("qwen3-14b", "decode_32k"), ("granite-moe-3b-a800m", "train_4k")])
def test_lm_terms_at_L_layers_equal_the_full_run(arch, shape):
    """The runs at 2 and 3 layers, extrapolated to 4, give the peak of
    the run at 4 layers exactly, and its collectives to ``COLL_REL``:
    DTensor redistributes the gradients of the stacked ``[L, ...]``
    parameters by the divisibility of L, so a layer's collectives
    alternate by a few KiB with L's parity."""
    over = dict(TINY, n_experts=4, top_k=2) \
        if get_arch(arch).config.is_moe else dict(TINY)
    with _Mesh((2, 4)) as mesh:
        rules = ShardingRules()
        cell = get_arch(arch).cell(shape, cfg_overrides=dict(over,
                                                             n_layers=4))
        ins, outs = cell.shardings(mesh, rules)
        full = cell.distributed(mesh, rules, ins, outs)
        got = lm_device_terms(get_arch(arch), shape, mesh, rules,
                              cfg_overrides=dict(over, n_layers=4))
    assert got[0] == full[0]
    assert {k for k, v in got[1].items() if v} == \
        {k for k, v in full[1].items() if v}
    for k, v in full[1].items():     # of the term's bytes, the total
        assert abs(got[1][k] - v) <= COLL_REL * full[1]["total"], \
            (k, got[1][k], v)
    assert full[1]["total"] > 0


@pytest.mark.parametrize("name", ["dlrm-rm2:train_batch", "gcn-cora:molecule",
                                  "gcn-cora:full_graph_sm", "mind:serve_p99",
                                  "two-tower-retrieval:serve_p99",
                                  "smollm-360m:prefill_32k",
                                  "smollm-360m:train_4k"])
def test_a_one_device_mesh_peak_is_the_plain_runs(name):
    """On a 1x1 mesh every placement is a replica: the DTensor run holds
    what the plain meta run holds (the models' DTensor paths run the
    plain ops on replicas, ``models.common.plain``), and issues no
    collective."""
    over = dict(TINY, n_layers=2) if name.startswith("smollm") else {}
    cell = _cell(name, **over)
    with OpCounter(cell.abstract_args) as plain:
        cell.fn(*cell.abstract_args)
    with _Mesh((1, 1)) as mesh:
        low = cell.lower(mesh)
    assert low.peak_bytes == plain.peak > 0
    assert low.collectives == {"total": 0}


def test_the_blocks_peak_is_its_local_bytes():
    """On (2, 4): x [B/2, D], w1 [D, F/4], w2 [F/4, D] resident, then the
    [B/2, D] partial product and its all-reduce, both alive at the end
    (x @ w1's [B/2, F/4] is freed before the all-reduce)."""
    with _Mesh((2, 4)) as mesh:
        low = _block().lower(mesh)
    f32 = 4
    args = (B // 2 * D + D * F // 4 + F // 4 * D) * f32
    assert low.argument_bytes == args
    assert low.peak_bytes == args + 2 * (B // 2 * D * f32)


def test_the_tracker_on_cpu_tensors_equals_meta():
    """A reduced LM's train step, once on real CPU tensors and once on
    meta: the same peak bytes of live storage."""
    cfg = TL.LMConfig(name="t", n_layers=2, dtype=torch.float32, **TINY)
    step, init_opt = make_train_step(
        lambda p, b: TL.causal_lm_loss(p, b, cfg, attention="plain"),
        AdamWConfig())
    peaks = []
    for dev in ("cpu", "meta"):
        p, _ = TL.load_params(cfg, seed=0, device="cpu")
        p = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(dev)) for k, v in p.items()}
        opt = init_opt(p)
        toks = torch.zeros(2, 16, dtype=torch.int32, device=dev)
        batch = {"tokens": toks, "labels": toks}
        with OpCounter((p, opt, batch)) as c:
            step(p, opt, batch)
        peaks.append(c.peak)
    assert peaks[0] == peaks[1] > 0
