"""Roofline terms of a dry-run cell, with NVIDIA H100 constants.

Counterpart of ``repro.launch.roofline``.  Three terms per (arch ×
shape × mesh), in seconds:

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / NVLINK_BW

The reference reads its FLOPs and bytes from XLA's ``cost_analysis()``
of the partitioned program and parses the collectives out of its HLO.
The port runs a cell once on the ``meta`` device instead (``Cell.lower``)
and counts with ``OpCounter``: FLOPs by
``torch.utils.flop_counter.FlopCounterMode`` (the matrix products and
attention; every layer, so no while-body correction is needed), bytes
as the sum of every aten op's operand and result bytes (the eager
counterpart of XLA's "bytes accessed").  The ``hlo_*`` field names are
kept for the records' schema.  Eager PyTorch has no partitioned program
to parse, so the collective term is ``None`` ("not derived", never 0)
until it is derived through DTensor's ``CommDebugMode``.

Hardware constants: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power
limit, from NVIDIA's data sheet: 989 TFLOP/s dense bf16 on the tensor
cores, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s per direction per GPU.

``roofline_fraction`` = ideal model time / estimated step time, where
the ideal time assumes the model's *useful* FLOPs (6·N·D style) run at
peak and the estimated step time is the largest derived term.
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.cost import (HOST_DISPATCH_OVERHEAD_S, HOST_MEM_BW,
                         HOST_PEAK_FLOPS, estimate_stage_cost)

# NVIDIA H100 80GB HBM3 SXM, 700 W (data sheet)
PEAK_FLOPS = 989e12         # bf16 dense FLOP/s, tensor cores
HBM_BW = 3.35e12            # bytes/s, HBM3
NVLINK_BW = 450e9           # bytes/s per direction per GPU, NVLink 4

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_RE = re.compile(
    r"=\s*(\([^)]*\)|[\w\[\],{}\s]*?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "HOST_PEAK_FLOPS",
           "HOST_MEM_BW", "HOST_DISPATCH_OVERHEAD_S",
           "parse_collective_bytes", "RooflineReport", "OpCounter",
           "analyze_lowered", "derive_terms", "apply_layer_correction",
           "estimate_stage_cost", "lm_model_flops", "gnn_model_flops",
           "recsys_model_flops", "model_flops_for"]


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def parse_collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum result-shape bytes per collective op type (per device) of an
    HLO text (``-start`` counted once, ``-done`` skipped)."""
    out: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        if "-done" in line:
            continue
        m = _COLLECTIVE_RE.search(line)
        if not m:
            continue
        shape_str, op = m.group(1), m.group(2)
        out[op] = out.get(op, 0) + _shape_bytes(shape_str)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def _tensor_bytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    return 0


class _ByteCounter(TorchDispatchMode):
    """Sums every aten op's operand and result bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.bytes += _tensor_bytes(args) + _tensor_bytes(kwargs) \
            + _tensor_bytes(out)
        return out


class OpCounter:
    """Context manager counting the FLOPs (``FlopCounterMode``) and the
    bytes accessed of the aten ops run inside it."""

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._flops = FlopCounterMode(display=False)
        self._bytes = _ByteCounter()
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        self.bytes = self._bytes.bytes
        self.flops = self._flops.get_total_flops()
        return False


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    kind: str
    # raw per-device quantities
    hlo_flops: float = 0.0
    hlo_bytes: float = 0.0
    #: None: not derived (the port has no partitioned program to parse)
    collective_bytes: Optional[float] = None
    collective_breakdown: Dict[str, int] = field(default_factory=dict)
    # memory (bytes per device); None where the meta run cannot tell
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None
    # derived terms (seconds)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: Optional[float] = None
    dominant: str = ""
    # useful-work accounting
    model_flops_global: float = 0.0
    useful_ratio: float = 0.0           # model_flops / (hlo_flops × chips)
    roofline_fraction: float = 0.0      # ideal model time / est step time
    est_step_s: float = 0.0
    compile_s: float = 0.0
    notes: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def summary(self) -> str:
        coll = "n/a" if self.collective_s is None \
            else f"{self.collective_s:.3e}s"
        return (f"{self.arch:24s} {self.shape:14s} {self.mesh:10s} "
                f"compute={self.compute_s:.3e}s memory={self.memory_s:.3e}s "
                f"coll={coll} dom={self.dominant:10s} "
                f"useful={self.useful_ratio:.2f} "
                f"roofline={self.roofline_fraction:.2%}")


def analyze_lowered(lowered, *, arch: str, shape: str, mesh_name: str,
                    n_devices: int, kind: str, model_flops_global: float,
                    compile_s: float = 0.0, notes: str = ""
                    ) -> RooflineReport:
    """The report of one ``Cell.lower`` (the counterpart of the
    reference's ``analyze_compiled``).  Per-device FLOPs, bytes and
    output bytes are the global counts over ``n_devices``: the ideal
    partition, where XLA's are those of the partitioned program.  The
    argument bytes per device are exact, from the sharding rules."""
    note = "collective term not derived: eager PyTorch has no " \
        "partitioned program to parse"
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        kind=kind, hlo_flops=lowered.flops / n_devices,
        hlo_bytes=lowered.bytes_accessed / n_devices,
        argument_bytes=int(lowered.argument_bytes),
        output_bytes=int(lowered.output_bytes // n_devices),
        model_flops_global=model_flops_global, compile_s=compile_s,
        notes=f"{notes} [{note}]" if notes else f"[{note}]")
    return derive_terms(rep)


def derive_terms(rep: RooflineReport) -> RooflineReport:
    """(Re-)derive the terms + fractions from the raw quantities.  A
    collective byte count of ``None`` leaves its term ``None``: it is
    not derived, and takes no part in the dominant term or the step
    estimate."""
    rep.compute_s = rep.hlo_flops / PEAK_FLOPS
    rep.memory_s = rep.hlo_bytes / HBM_BW
    rep.collective_s = None if rep.collective_bytes is None \
        else rep.collective_bytes / NVLINK_BW
    terms = {"compute": rep.compute_s, "memory": rep.memory_s}
    if rep.collective_s is not None:
        terms["collective"] = rep.collective_s
    rep.dominant = max(terms, key=terms.get)
    rep.est_step_s = max(terms.values())
    total_flops = rep.hlo_flops * rep.n_devices
    rep.useful_ratio = (rep.model_flops_global / total_flops
                        if total_flops else 0.0)
    ideal = rep.model_flops_global / (rep.n_devices * PEAK_FLOPS)
    rep.roofline_fraction = ideal / rep.est_step_s if rep.est_step_s else 0.0
    return rep


def apply_layer_correction(rep: RooflineReport, probe: RooflineReport,
                           n_layers: int) -> RooflineReport:
    """total ≈ scanned_module + (L-1) × single-layer probe (the
    reference's correction for XLA counting a while body once).  The
    port's counts cover every layer and its dry run does not call this;
    it is kept for records taken from a scanned program.  A ``None``
    collective count on either side stays ``None``."""
    rep.hlo_flops += (n_layers - 1) * probe.hlo_flops
    rep.hlo_bytes += (n_layers - 1) * probe.hlo_bytes
    if rep.collective_bytes is None or probe.collective_bytes is None:
        rep.collective_bytes = None
    else:
        rep.collective_bytes += (n_layers - 1) * probe.collective_bytes
        for k, v in probe.collective_breakdown.items():
            rep.collective_breakdown[k] = \
                rep.collective_breakdown.get(k, 0) + (n_layers - 1) * v
    rep.notes = (rep.notes + " " if rep.notes else "") + \
        f"[layer-corrected: +{n_layers - 1}x probe]"
    return derive_terms(rep)


# ---------------------------------------------------------------------------
# useful-FLOPs models (the 6·N·D convention + family-specific variants)
# ---------------------------------------------------------------------------

def lm_model_flops(cfg, seq_len: int, global_batch: int, kind: str) -> float:
    from ..models.lm import active_params
    n_active = active_params(cfg)
    tokens = global_batch * seq_len
    if kind == "train":
        return 6.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the cache
    attn = (2.0 * 2.0 * cfg.n_layers * global_batch * seq_len
            * cfg.n_heads * cfg.head_dim)
    return 2.0 * n_active * global_batch + attn


def gnn_model_flops(cfg, sh: Dict) -> float:
    """2·(matmul flops) ×3 for training (fwd+bwd)."""
    mult = 3.0 if sh["kind"].startswith("train") else 1.0
    F, H, C = sh["d_feat"], cfg.d_hidden, sh["n_classes"]
    if "batch_nodes" in sh:         # sampled: count gathered node compute
        f1, f2 = sh["fanouts"]
        n_eff = sh["batch_nodes"] * (1 + f1 + f1 * f2)
        dense = 2.0 * n_eff * F * H + 2.0 * sh["batch_nodes"] * H * C
        return mult * dense
    if "batch" in sh:               # molecules
        n = sh["batch"] * sh["n_nodes"]
        e = sh["batch"] * sh["n_edges"]
    else:
        n, e = sh["n_nodes"], sh["n_edges"]
    dense = 2.0 * n * F * H + 2.0 * n * H * C
    agg = 2.0 * e * (H + C)
    return mult * (dense + agg)


def recsys_model_flops(cfg, sh: Dict) -> float:
    mult = 6.0 if sh["kind"] == "train" else 2.0
    B = sh.get("batch", 1)
    if sh["kind"] == "retrieval":
        B = sh["n_candidates"]

    def mlp_flops(dims, d0):
        f, prev = 0.0, d0
        for d in dims:
            f += prev * d
            prev = d
        return f

    if cfg.kind == "dlrm":
        per_row = (mlp_flops(cfg.bot_mlp, cfg.n_dense)
                   + mlp_flops(cfg.top_mlp,
                               (cfg.n_sparse + 1) * cfg.n_sparse // 2
                               + cfg.bot_mlp[-1])
                   + (cfg.n_sparse + 1) ** 2 * cfg.embed_dim)
    elif cfg.kind == "dcn":
        d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
        per_row = (cfg.n_cross_layers * d0 * d0
                   + mlp_flops(cfg.deep_mlp, d0) + d0 + cfg.deep_mlp[-1])
    elif cfg.kind == "mind":
        d = cfg.embed_dim
        per_row = (cfg.hist_len * d * d                       # bilinear S
                   + cfg.capsule_iters * 2 * cfg.n_interests
                   * cfg.hist_len * d
                   + cfg.n_interests * (2 * d * d + d * d))   # interest MLP
        if sh["kind"] == "retrieval":
            return mult * (per_row + B * cfg.n_interests * d)
    else:  # two_tower
        d = cfg.embed_dim
        per_row = 2 * mlp_flops(cfg.tower_mlp, d)             # both towers
        if sh["kind"] == "retrieval":
            return mult * (mlp_flops(cfg.tower_mlp, d)
                           + B * (mlp_flops(cfg.tower_mlp, d)
                                  + cfg.tower_mlp[-1]))
    return mult * B * per_row


def model_flops_for(arch_def, shape_name: str) -> float:
    from ..configs.base import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES
    if arch_def.family == "lm":
        sh = LM_SHAPES[shape_name]
        return lm_model_flops(arch_def.config, sh["seq_len"],
                              sh["global_batch"], sh["kind"])
    if arch_def.family == "gnn":
        return gnn_model_flops(arch_def.config, GNN_SHAPES[shape_name])
    return recsys_model_flops(arch_def.config, RECSYS_SHAPES[shape_name])
