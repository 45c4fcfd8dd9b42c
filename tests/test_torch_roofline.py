"""The port's roofline module against the reference's
(``tests/test_roofline_launch.py``), with the H100 constants: the HLO
collective parser, the terms and the dominant one (a collective count of
``None`` is "not derived", never 0), the layer correction, the useful
FLOPs formulas, ``model_flops_for`` equal to the reference's on all 40
cells, and the mesh factory's contract."""
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.configs as jconfigs
from repro.launch import roofline as jroof

import repro_torch.launch.roofline as troof
from repro_torch.configs import ARCHS, GNN_SHAPES, RECSYS_SHAPES, all_cells
from repro_torch.launch.roofline import (HBM_BW, NVLINK_BW, PEAK_FLOPS,
                                         RooflineReport,
                                         apply_layer_correction,
                                         derive_terms, gnn_model_flops,
                                         lm_model_flops,
                                         parse_collective_bytes,
                                         recsys_model_flops)
from repro_torch.models.lm import active_params, num_params

torch.set_num_threads(1)

HLO = """
ENTRY main {
  %p0 = bf16[1024,512]{1,0} parameter(0)
  %ag = bf16[16384,512]{1,0} all-gather(%p0), dimensions={0}
  %ar.1 = f32[256,128]{1,0} all-reduce(%x), to_apply=%add
  %rs = f32[16,128]{1,0} reduce-scatter(%y), dimensions={0}
  %a2a = (bf16[8,64]{1,0}, bf16[8,64]{1,0}) all-to-all(%z, %w)
  %cp-start = bf16[32,32]{1,0} collective-permute-start(%q)
  %cp-done = bf16[32,32]{1,0} collective-permute-done(%cp-start)
  %dot = f32[128,128]{1,0} dot(%a, %b)
}
"""


def test_h100_constants():
    """NVIDIA H100 80GB HBM3 SXM at 700 W (data sheet), not the TPU
    v5e's; the link term is NVLink's, under its own name."""
    assert (PEAK_FLOPS, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert not hasattr(troof, "ICI_BW")


def test_parse_collective_bytes_equals_reference():
    out = parse_collective_bytes(HLO)
    assert out == jroof.parse_collective_bytes(HLO)
    assert out["all-gather"] == 16384 * 512 * 2
    assert out["collective-permute"] == 32 * 32 * 2   # -done not counted
    assert out["total"] == sum(v for k, v in out.items() if k != "total")


def test_derive_terms_and_dominant():
    rep = RooflineReport(arch="a", shape="s", mesh="16x16", n_devices=256,
                         kind="train", hlo_flops=PEAK_FLOPS,
                         hlo_bytes=HBM_BW * 10,
                         collective_bytes=NVLINK_BW * 2,
                         model_flops_global=PEAK_FLOPS * 256)
    derive_terms(rep)
    assert rep.compute_s == pytest.approx(1.0)
    assert rep.memory_s == pytest.approx(10.0)
    assert rep.collective_s == pytest.approx(2.0)
    assert rep.dominant == "memory"
    assert rep.roofline_fraction == pytest.approx(0.1)
    assert rep.useful_ratio == pytest.approx(1.0)


def test_an_underived_collective_term_is_none_not_zero():
    rep = RooflineReport(arch="a", shape="s", mesh="16x16", n_devices=256,
                         kind="train", hlo_flops=PEAK_FLOPS * 3,
                         hlo_bytes=HBM_BW, model_flops_global=1.0)
    derive_terms(rep)
    assert rep.collective_bytes is None and rep.collective_s is None
    assert rep.dominant == "compute" and rep.est_step_s == pytest.approx(3.0)
    assert "coll=n/a" in rep.summary()
    assert rep.to_dict()["collective_s"] is None


def test_layer_correction_math():
    rep = RooflineReport(arch="a", shape="s", mesh="m", n_devices=256,
                         kind="train", hlo_flops=10.0, hlo_bytes=20.0,
                         collective_bytes=2.0,
                         collective_breakdown={"all-gather": 2, "total": 2},
                         model_flops_global=1.0)
    probe = RooflineReport(arch="a", shape="s", mesh="m", n_devices=256,
                           kind="probe", hlo_flops=3.0, hlo_bytes=4.0,
                           collective_bytes=1.0,
                           collective_breakdown={"all-gather": 1,
                                                 "total": 1})
    apply_layer_correction(rep, probe, n_layers=5)
    assert (rep.hlo_flops, rep.hlo_bytes, rep.collective_bytes) == \
        (10.0 + 4 * 3.0, 20.0 + 4 * 4.0, 2.0 + 4 * 1.0)
    assert rep.collective_breakdown["all-gather"] == 2 + 4
    probe.collective_bytes = None
    apply_layer_correction(rep, probe, n_layers=2)
    assert rep.collective_bytes is None and rep.collective_s is None


def test_model_flops_formulas():
    q = ARCHS["qwen1.5-110b"].config
    f_train = lm_model_flops(q, 4096, 256, "train")
    assert f_train == pytest.approx(3 * lm_model_flops(q, 4096, 256,
                                                       "prefill"))
    phi = ARCHS["phi3.5-moe-42b-a6.6b"].config
    f_phi = lm_model_flops(phi, 4096, 256, "train")
    assert f_phi == pytest.approx(6 * active_params(phi) * 256 * 4096)
    assert f_phi < 6 * num_params(phi) * 256 * 4096 * 0.3
    assert lm_model_flops(q, 32768, 128, "decode") < f_train / 100
    g = ARCHS["gcn-cora"].config
    assert gnn_model_flops(g, GNN_SHAPES["ogb_products"]) > \
        gnn_model_flops(g, GNN_SHAPES["full_graph_sm"])
    d = ARCHS["dlrm-rm2"].config
    assert recsys_model_flops(d, RECSYS_SHAPES["train_batch"]) > \
        recsys_model_flops(d, RECSYS_SHAPES["serve_p99"])


@pytest.mark.parametrize("arch,shape", all_cells())
def test_model_flops_for_equals_reference(arch, shape):
    assert troof.model_flops_for(ARCHS[arch], shape) == \
        jroof.model_flops_for(jconfigs.get_arch(arch), shape)


def test_host_priors_are_the_cost_models():
    """``estimate_stage_cost`` and the host priors live in
    ``core.cost``; the roofline module re-exports them."""
    from repro_torch.core import cost
    assert troof.estimate_stage_cost is cost.estimate_stage_cost
    assert (troof.HOST_PEAK_FLOPS, troof.HOST_MEM_BW,
            troof.HOST_DISPATCH_OVERHEAD_S) == \
        (jroof.HOST_PEAK_FLOPS, jroof.HOST_MEM_BW,
         jroof.HOST_DISPATCH_OVERHEAD_S)


def test_mesh_factory_contract():
    """Importing mesh.py touches no device and no process group; the
    factory's shapes and axes are the reference's."""
    from repro_torch.launch import mesh as mesh_mod
    src = inspect.getsource(mesh_mod)
    assert "(2, 16, 16)" in src and "(16, 16)" in src
    assert '("pod", "data", "model")' in src
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch.distributed as d, repro_torch.launch.mesh as m\n"
         "print(d.is_initialized(), m.mesh_info.__name__)"],
        env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                            .parents[1] / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "mesh_info"]
