"""Roofline terms of a dry-run cell, with NVIDIA H100 constants.

Counterpart of ``repro.launch.roofline``.  Three terms per (arch ×
shape × mesh), in seconds:

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / NVLINK_BW

The reference reads its FLOPs and bytes from XLA's ``cost_analysis()``
of the partitioned program, parses the collectives out of its HLO and
takes its peak from ``memory_analysis()``.  The port runs a cell on the
``meta`` device instead (``Cell.lower``) and counts with ``OpCounter``:

* FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` (the matrix
  products and attention; every layer, so no while-body correction is
  needed) and bytes as the sum of every aten op's operand and result
  bytes (the eager counterpart of XLA's "bytes accessed"), both over
  plain meta tensors, i.e. global;
* the collectives: the ``c10d_functional`` collectives that DTensor
  issues when the cell runs on DTensor arguments (meta local shards) on
  the mesh, booked as ``parse_collective_bytes`` books XLA's: the result
  bytes per device, by op type, under XLA's names.  An all-to-all is
  booked as one all-to-all, though DTensor runs it on a ``"cpu"`` mesh
  as an all-gather and a chunk.  A dim split over several mesh axes is
  gathered by DTensor in one all-gather per axis, and each is booked
  (XLA issues one all-gather over the flattened group: DTensor's
  count is larger by the bytes of the partial gathers);
* the peak: the most bytes of live storage the run holds at once
  (arguments, intermediates, tensors saved for backward), of the local
  shards under DTensor, so one device's peak.  XLA's comes from its
  buffer assignment; this one is what a caching allocator would count.

The ``hlo_*`` field names are kept for the records' schema.

Hardware constants: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power
limit, from NVIDIA's data sheet: 989 TFLOP/s dense bf16 on the tensor
cores, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s per direction per GPU.

``roofline_fraction`` = ideal model time / estimated step time, where
the ideal time assumes the model's *useful* FLOPs (6·N·D style) run at
peak and the estimated step time is the largest derived term.
"""
from __future__ import annotations

import re
import weakref
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
           "DeviceCounter", "COLLECTIVE_OPS",
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


#: the collective ops' names (``_c10d_functional``) -> XLA's op names
COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional")
#: the ops of those namespaces that move no data (their result is the
#: collective's own on a device, whatever the meta kernel allocates)
_COLLECTIVE_HELPERS = ("wait_tensor", "_wrap_tensor_autograd")
#: the modules of DTensor that hold ``shard_dim_alltoall`` by name
_ALLTOALL_CALLERS = ("torch.distributed.tensor._collective_utils",
                     "torch.distributed.tensor.placement_types")


def _storages(x: Any):
    if isinstance(x, torch.Tensor):
        yield x.untyped_storage()
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _storages(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _storages(v)


class DeviceCounter(TorchDispatchMode):
    """One device's side of a run: the bytes of live storage (``live``,
    its maximum ``peak``) and the collectives (``collectives``: result
    bytes by XLA's op name, and ``total``).

    A storage is counted once, when an op first returns it (``hold``
    adds the ones that exist before the run: the arguments), and until
    it is freed (a weak reference to it).  Under DTensor the mode lets
    DTensor run first (``NotImplemented`` for a tensor subclass) and
    sees the local ops it issues: the local shards and the collectives
    (the fake tensors of its shape inference are not counted).  A
    collective it does not know raises: nothing is skipped."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.collectives: Dict[str, int] = {"total": 0}
        self._refs: Dict[int, Any] = {}
        self._booked = 0          # > 0: inside an op booked as a whole

    def hold(self, tree: Any) -> None:
        """Count the storages of the plain tensors (a DTensor's local
        shard) in ``tree``: nested dicts, lists and tuples."""
        from torch.distributed.tensor import DTensor

        def local(x):
            if isinstance(x, DTensor):
                return x.to_local()
            if isinstance(x, dict):
                return {k: local(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [local(v) for v in x]
            return x
        for st in _storages(local(tree)):
            self._track(st)

    def _track(self, st) -> None:
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self.live -= n
            self._refs.pop(key, None)
        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def book(self, op: str, n_bytes: int) -> None:
        self.collectives[op] = self.collectives.get(op, 0) + int(n_bytes)
        self.collectives["total"] += int(n_bytes)

    def _alltoall(self, orig):
        """DTensor's ``shard_dim_alltoall``, booked as one all-to-all of
        its result, whatever it runs (on a ``"cpu"`` mesh an all-gather
        and a chunk): its collectives and buffers are not counted, its
        result is, as an all-to-all's."""
        def alltoall(*args, **kwargs):
            self._booked += 1
            try:
                out = orig(*args, **kwargs)
            finally:
                self._booked -= 1
            self.book("all-to-all", _tensor_bytes(out))
            for st in _storages(out):
                self._track(st)
            return out
        return alltoall

    def __enter__(self):
        import importlib
        self._patched = []
        for name in _ALLTOALL_CALLERS:
            mod = importlib.import_module(name)
            orig = getattr(mod, "shard_dim_alltoall", None)
            if orig is not None:
                self._patched.append((mod, orig))
                mod.shard_dim_alltoall = self._alltoall(orig)
        return super().__enter__()

    def __exit__(self, *exc):
        for mod, orig in self._patched:
            mod.shard_dim_alltoall = orig
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(t is not torch.Tensor for t in types) or \
                torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation infers global shapes under a
            # fake mode: no device's storage, no collective
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if self._booked:
            return out
        if func.namespace == "_dtensor" and \
                func._overloadpacket.__name__ == "shard_dim_alltoall":
            self.book("all-to-all", _tensor_bytes(out))
        elif func.namespace in _COLLECTIVE_NAMESPACES:
            name = func._overloadpacket.__name__
            if name in _COLLECTIVE_HELPERS:
                return out      # the collective's own result, on a device
            if name not in COLLECTIVE_OPS:
                raise NotImplementedError(f"collective {func} has no "
                                          "booking")
            self.book(COLLECTIVE_OPS[name], _tensor_bytes(out))
        for st in _storages(out):
            self._track(st)
        return out


class OpCounter:
    """Context manager counting the FLOPs (``FlopCounterMode``), the
    bytes accessed of the aten ops run inside it and the peak bytes of
    live storage (``DeviceCounter``; ``hold`` the arguments first)."""

    def __init__(self, args: Any = None):
        self._args = args

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._flops = FlopCounterMode(display=False)
        self._bytes = _ByteCounter()
        self._device = DeviceCounter()
        self._device.hold(self._args)
        self._flops.__enter__()
        self._bytes.__enter__()
        self._device.__enter__()
        return self

    def __exit__(self, *exc):
        self._device.__exit__(*exc)
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        self.bytes = self._bytes.bytes
        self.flops = self._flops.get_total_flops()
        self.peak = self._device.peak
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
    #: None: not derived (``derive_terms`` leaves its term None)
    collective_bytes: Optional[float] = None
    collective_breakdown: Dict[str, int] = field(default_factory=dict)
    # memory (bytes per device); peak = argument + temp
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
    argument bytes per device are exact, from the sharding rules; the
    collectives and the peak are one device's, from the DTensor run, and
    ``temp_bytes`` is the peak less the arguments.  A ``Lowered``
    without collectives or a peak raises: no term is left out."""
    if lowered.collectives is None or lowered.peak_bytes is None:
        raise ValueError(f"{arch} {shape} on {mesh_name}: the run derived "
                         "no collectives or no peak")
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        kind=kind, hlo_flops=lowered.flops / n_devices,
        hlo_bytes=lowered.bytes_accessed / n_devices,
        collective_bytes=float(lowered.collectives["total"]),
        collective_breakdown=dict(lowered.collectives),
        argument_bytes=int(lowered.argument_bytes),
        output_bytes=int(lowered.output_bytes // n_devices),
        peak_bytes=int(lowered.peak_bytes),
        temp_bytes=int(lowered.peak_bytes - lowered.argument_bytes),
        model_flops_global=model_flops_global, compile_s=compile_s,
        notes=notes)
    return derive_terms(rep)


def derive_terms(rep: RooflineReport) -> RooflineReport:
    """(Re-)derive the three terms + fractions from the raw quantities
    (the reference's formula, with ``NVLINK_BW`` for its link rate).  A
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
