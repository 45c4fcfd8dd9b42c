"""Arch/shape cell builders for the dry run and the smoke tests.

Counterpart of ``repro.configs.base``.  Every assigned architecture is
an ``ArchDef``; every (arch × shape) pair builds a ``Cell``: a step
function, its abstract inputs (tensors on the ``meta`` device: shapes
and dtypes, no memory) and the logical specs of those inputs.  Running
a Cell on the meta device under a production mesh's sharding rules is
the port's multi-pod dry run (``Cell.lower``).

Shape semantics per the assignment:
* LM ``train_*``   -> train_step (fwd+bwd+AdamW)
* LM ``prefill_*`` -> prefill (forward, builds KV cache)
* LM ``decode_*`` / ``long_*`` -> decode_step (1 token vs KV cache)
* GNN / recsys ``train*`` -> train_step; ``serve*``/``retrieval*`` ->
  forward-only serving step.

LM cells call the models with ``attention="plain"``: the plain
attention the reference's cells lower, and the only one that
differentiates (the kernel ops refuse autograd).  A decode cell's
position is the cache's last (``S - 1``), a Python int as
``decode_one`` takes it; the reference traces it as a scalar.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..distrib.shardings import (ShardingRules, batch_axes, local_shape,
                                 mesh_sizes, shard_bytes)
from ..models import gcn as GCN
from ..models import lm as LM
from ..models import recsys as RS
from ..models.common import ParamSpec, abstract_params, load_weights
from ..train.loop import make_train_step
from ..train.optimizer import AdamWConfig, adamw_state_specs

__all__ = ["ArchDef", "Cell", "Lowered", "LM_SHAPES", "GNN_SHAPES",
           "RECSYS_SHAPES", "lm_arch", "gnn_arch", "recsys_arch",
           "lm_layer_probe", "lm_device_terms"]


def _sds(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _zip_like(args, other) -> List[Tuple[Any, Any]]:
    """(leaf of ``args``, the node of ``other`` at its place), walking
    ``args``' structure, so a spec tuple stays one node."""
    if isinstance(args, dict):
        return [p for k in args for p in _zip_like(args[k], other[k])]
    if isinstance(args, (list, tuple)):
        return [p for a, o in zip(args, other) for p in _zip_like(a, o)]
    return [(args, other)]


def _zip_map(fn, args, other):
    """``fn(leaf, node)`` over the leaves of ``args`` and the nodes of
    ``other`` at their places (as ``_zip_like``), in ``args``' shape."""
    if isinstance(args, dict):
        return {k: _zip_map(fn, args[k], other[k]) for k in args}
    if isinstance(args, (list, tuple)):
        return type(args)(_zip_map(fn, a, o) for a, o in zip(args, other))
    return fn(args, other)


@dataclass
class Lowered:
    """What one run of a cell on the meta device gives the dry run:
    global FLOPs (``FlopCounterMode``) and bytes accessed (every aten
    op's operands and results), argument bytes per device from the
    rules, global output bytes, and the seconds it took; on a
    ``DeviceMesh``, one device's peak bytes of live storage and its
    collectives (result bytes by XLA's op name, and ``total``) from the
    run on DTensor arguments, and the redistributions the models noted
    (``notes``).  ``None``: not derived (a duck-typed mesh)."""
    flops: float
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    seconds: float
    in_specs: Tuple[Any, ...]
    peak_bytes: Optional[int] = None
    collectives: Optional[Dict[str, int]] = None
    notes: str = ""


@dataclass
class Cell:
    """One dry-run cell: arch × shape, ready to run on a mesh."""
    arch: str
    shape: str
    kind: str                                  # train|prefill|decode|serve
    fn: Callable
    abstract_args: Tuple[Any, ...]
    #: per-arg: either a ParamSpec tree (resolved via rules) or a
    #: callable (mesh, rules) -> spec tree, or None (replicated)
    arg_spec_trees: Tuple[Any, ...]
    out_spec_trees: Optional[Tuple[Any, ...]] = None
    donate_argnums: Tuple[int, ...] = ()
    notes: str = ""

    def shardings(self, mesh, rules: ShardingRules):
        """(input spec trees, output spec trees or None): each spec a
        tuple as ``ShardingRules.spec_for`` returns it."""
        def resolve(tree, args_abs):
            if tree is None:
                return _tree_map(lambda _: (), args_abs)
            if callable(tree):
                return tree(mesh, rules)
            return rules.tree_specs(tree, mesh)
        ins = tuple(resolve(t, a) for t, a in
                    zip(self.arg_spec_trees, self.abstract_args))
        outs = None
        if self.out_spec_trees is not None:
            outs = tuple(None if t is None else resolve(t, None)
                         for t in self.out_spec_trees)
        return ins, outs

    def lower(self, mesh, rules: Optional[ShardingRules] = None, *,
              counted: Optional[Lowered] = None,
              distributed: bool = True) -> Lowered:
        """Resolve the shardings on ``mesh``, enter
        ``activation_sharding`` and run ``fn`` once on the plain meta
        tensors, counting its FLOPs and bytes (``launch.roofline.
        OpCounter``); these do not depend on the mesh, so ``counted``,
        this cell's ``Lowered`` on another mesh, lends them.  On a
        ``DeviceMesh`` (a process group of its size set up), ``fn`` then
        runs again on DTensor arguments, meta local shards placed by
        ``placements_for``, for one device's peak and collectives
        (``distributed``; ``distributed=False`` leaves them ``None``):
        these depend on the mesh and are never lent."""
        from ..launch.roofline import OpCounter
        from ..models.common import activation_sharding
        rules = rules or ShardingRules()
        t0 = time.perf_counter()
        in_specs, out_specs = self.shardings(mesh, rules)
        arg_bytes = sum(
            shard_bytes(a.shape, a.element_size(), s, mesh)
            for a, s in _zip_like(self.abstract_args, in_specs)
            if isinstance(a, torch.Tensor))
        if counted is not None:
            low = replace(counted, argument_bytes=arg_bytes,
                          in_specs=in_specs, peak_bytes=None,
                          collectives=None, notes="")
        else:
            counter = OpCounter(self.abstract_args)
            with activation_sharding(mesh, rules.spec_for), counter:
                out = self.fn(*self.abstract_args)
            out_bytes = sum(t.numel() * t.element_size()
                            for t, _ in _zip_like(out, out)
                            if isinstance(t, torch.Tensor))
            del out
            low = Lowered(flops=counter.flops, bytes_accessed=counter.bytes,
                          argument_bytes=arg_bytes, output_bytes=out_bytes,
                          seconds=0.0, in_specs=in_specs)
        from torch.distributed.device_mesh import DeviceMesh
        if distributed and isinstance(mesh, DeviceMesh):
            low.peak_bytes, low.collectives, low.notes = \
                self.distributed(mesh, rules, in_specs, out_specs)
        low.seconds = time.perf_counter() - t0
        return low

    def distributed(self, mesh, rules: ShardingRules, in_specs,
                    out_specs) -> Tuple[int, Dict[str, int], str]:
        """(peak bytes, collectives, notes) of one device: ``fn`` run
        once on DTensor arguments (meta local shards) on ``mesh`` under
        ``activation_sharding``, counted by ``launch.roofline.
        DeviceCounter``.  The outputs are then placed as
        ``out_spec_trees`` says, or, where it says nothing, a partial
        sum is reduced to a replica (XLA's program returns no partial
        sums); the collectives that takes are counted too."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from ..distrib.shardings import placements_for
        from ..launch.roofline import DeviceCounter
        from ..models.common import activation_sharding, act_notes

        def dtensor(a, spec):
            if not isinstance(a, torch.Tensor):
                return a
            local = torch.empty(local_shape(a.shape, spec, mesh),
                                dtype=a.dtype, device="meta")
            return DTensor.from_local(local, mesh,
                                      placements_for(spec, mesh),
                                      run_check=False, shape=a.shape,
                                      stride=a.stride())

        def settle(t, spec):
            if not isinstance(t, DTensor):
                return t
            if spec is not None:
                want = placements_for(spec, mesh)
            else:
                want = tuple(Replicate() if isinstance(p, Partial) else p
                             for p in t.placements)
            return t.redistribute(mesh, want)

        args = _zip_map(dtensor, self.abstract_args, in_specs)
        outs = out_specs if out_specs is not None else \
            (None,) * len(args)
        counter = DeviceCounter()
        counter.hold(args)
        with activation_sharding(mesh, rules.spec_for), act_notes() as notes, \
                counter:
            out = self.fn(*args)
            if not isinstance(out, tuple):
                out = (out,)
            out = tuple(
                _tree_map(lambda t: settle(t, None), o) if spec is None
                else _zip_map(settle, o, spec)
                for o, spec in zip(out, outs + (None,) * len(out)))
        del out
        return counter.peak, dict(counter.collectives), \
            "; ".join(sorted(set(notes)))


@dataclass
class ArchDef:
    name: str
    family: str                    # lm | gnn | recsys
    config: Any
    source: str = ""
    notes: str = ""
    cell_builder: Optional[Callable] = None
    smoke_builder: Optional[Callable] = None

    def shape_names(self) -> List[str]:
        return list({"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                     "recsys": RECSYS_SHAPES}[self.family])

    def cell(self, shape_name: str, **overrides) -> Cell:
        return self.cell_builder(self, shape_name, **overrides)

    def smoke(self):
        """(reduced config, run(params=None, ..., device=None) -> dict of
        output tensors).  ``params`` is a nested dict of numpy arrays in
        the reference's layout (bridged); without it the weights come
        from ``torch.Generator().manual_seed(0)``."""
        return self.smoke_builder(self)


# ---------------------------------------------------------------------------
# shape tables (from the assignment)
# ---------------------------------------------------------------------------

LM_SHAPES: Dict[str, Dict] = {
    "train_4k":    dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k":  dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524288, global_batch=1, kind="decode",
                        window=8192),
}

GNN_SHAPES: Dict[str, Dict] = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg":  dict(kind="train_sampled", n_nodes=232965,
                          n_edges=114615892, batch_nodes=1024,
                          fanouts=(15, 10), d_feat=602, n_classes=41),
    "ogb_products":  dict(kind="train", n_nodes=2449029, n_edges=61859140,
                          d_feat=100, n_classes=47),
    "molecule":      dict(kind="train_mol", n_nodes=30, n_edges=64,
                          batch=128, d_feat=64, n_classes=10),
}

RECSYS_SHAPES: Dict[str, Dict] = {
    "train_batch":    dict(kind="train", batch=65536),
    "serve_p99":      dict(kind="serve", batch=512),
    "serve_bulk":     dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _batch_spec(mesh, ndim: int, dim0: Optional[int]) -> tuple:
    """dim0 over the batch mesh axes, trailing axes pruned until dim0
    divides (long_500k has global_batch=1: batch stays replicated)."""
    ax = list(batch_axes(mesh))
    if dim0 is not None:
        sizes = mesh_sizes(mesh)
        while ax and dim0 % int(np.prod([sizes[a] for a in ax])):
            ax.pop()
    return (tuple(ax) if len(ax) > 1 else (ax[0] if ax else None),) \
        + (None,) * (ndim - 1)


def _batch_sharding_fn(ndim: int, dim0: Optional[int] = None):
    def f(mesh, rules):
        return _batch_spec(mesh, ndim, dim0)
    return f


def _batch_tree_fn(tree_shapes: Dict[str, Tuple[int, int]]):
    """dict field -> (ndim, dim0); shards dim0 on the batch axes when it
    divides their product, else replicates (the reference's rule)."""
    def f(mesh, rules):
        ax = batch_axes(mesh)
        sizes = mesh_sizes(mesh)
        n = int(np.prod([sizes[a] for a in ax])) if ax else 1
        out = {}
        for k, (ndim, dim0) in tree_shapes.items():
            use = ax if (n and dim0 % max(n, 1) == 0) else ()
            out[k] = (use if len(use) > 1 else (use[0] if use else None),) \
                + (None,) * (ndim - 1)
        return out
    return f


def _lm_cfg(arch: "ArchDef", sh: Dict, cfg_overrides: Optional[Dict]):
    cfg: LM.LMConfig = arch.config
    if "window" in sh:
        cfg = replace(cfg, attn_window=sh["window"])
    if cfg_overrides:
        cfg = replace(cfg, **cfg_overrides)
    return cfg


def _lm_cell(arch: "ArchDef", shape_name: str, *,
             rules: Optional[ShardingRules] = None,
             cfg_overrides: Optional[Dict] = None,
             opt_cfg: Optional[AdamWConfig] = None) -> Cell:
    sh = LM_SHAPES[shape_name]
    S, B, kind = sh["seq_len"], sh["global_batch"], sh["kind"]
    cfg = _lm_cfg(arch, sh, cfg_overrides)
    opt_cfg = opt_cfg or AdamWConfig()
    specs = LM.param_specs(cfg)
    params_abs = abstract_params(specs)

    if kind == "train":
        def loss(p, b):
            return LM.causal_lm_loss(p, b, cfg, attention="plain")
        step_fn, _ = make_train_step(loss, opt_cfg)
        opt_specs = {"adam": adamw_state_specs(specs,
                                               opt_cfg.moment_dtype)}
        opt_abs = abstract_params(opt_specs)
        batch_abs = {"tokens": _sds((B, S)), "labels": _sds((B, S))}
        batch_fn = _batch_tree_fn({"tokens": (2, B), "labels": (2, B)})
        return Cell(arch.name, shape_name, kind, step_fn,
                    (params_abs, opt_abs, batch_abs),
                    (specs, opt_specs, batch_fn),
                    out_spec_trees=(specs, opt_specs, None),
                    donate_argnums=(0, 1))

    if kind == "prefill":
        def fn(p, t):
            return LM.prefill(p, t, cfg, attention="plain")
        return Cell(arch.name, shape_name, kind, fn,
                    (params_abs, _sds((B, S))),
                    (specs, _batch_sharding_fn(2, B)))

    # decode
    cache_specs = LM.init_cache_specs(cfg, B, S)
    cache_abs = abstract_params(cache_specs)

    def fn(p, c, t, pos):
        return LM.decode_one(p, c, t, pos, cfg, attention="plain")
    return Cell(arch.name, shape_name, "decode", fn,
                (params_abs, cache_abs, _sds((B,)), S - 1),
                (specs, cache_specs, _batch_sharding_fn(1, B), None),
                donate_argnums=(1,),
                notes=("windowed-attention variant (published config is "
                       "full attention; see DESIGN.md §long-context)"
                       if "window" in sh else ""))


def _strip_layer_dim(s: ParamSpec) -> ParamSpec:
    return ParamSpec(s.shape[1:], s.logical_axes[1:], s.dtype, init=s.init)


def lm_layer_probe(arch: "ArchDef", shape_name: str,
                   cfg_overrides: Optional[Dict] = None) -> Cell:
    """Single-layer probe cell: one transformer block at the cell's
    exact activation shapes and shardings.  The reference compiles it to
    correct XLA's while-body-once cost accounting (total = scanned
    module + (L - 1) × probe).  The port runs every layer eagerly, so
    its counts need no correction; the probe checks them instead: a
    cell's FLOPs are its L = 0 cell's plus L × the probe's.  The train
    probe runs its layer under the config's ``remat``, as ``forward``
    runs each layer (the reference's probe remats under ``"full"``)."""
    sh = LM_SHAPES[shape_name]
    S, B, kind = sh["seq_len"], sh["global_batch"], sh["kind"]
    cfg = replace(_lm_cfg(arch, sh, cfg_overrides), scan_layers=False)
    layer_specs = {k: _strip_layer_dim(s)
                   for k, s in LM.param_specs(cfg)["layers"].items()}
    layer_abs = abstract_params(layer_specs)
    D = cfg.d_model

    if kind in ("train", "prefill"):
        x_abs = _sds((B, S, D), cfg.dtype)
        if kind == "train":
            def fn(x, layer):
                names = sorted(layer)
                leaves = [x.detach().requires_grad_(True)] + \
                    [layer[n].detach().requires_grad_(True) for n in names]
                with torch.enable_grad():
                    out, aux = LM.remat_layer(
                        leaves[0], dict(zip(names, leaves[1:])), cfg,
                        attention="plain")
                    proxy = out.float().sum() + aux
                    return torch.autograd.grad(proxy, leaves)
        else:
            def fn(x, layer):
                out, _, kv = LM.layer_forward(x, layer, cfg,
                                              attention="plain")
                return out, kv
        return Cell(arch.name, shape_name, f"probe_{kind}", fn,
                    (x_abs, layer_abs),
                    (_batch_sharding_fn(3, B), layer_specs))

    # decode probe: one layer's head-major cache [B, K, S, hd]
    K, hd = cfg.n_kv_heads, cfg.head_dim
    x_abs = _sds((B, D), cfg.dtype)
    cache_spec = ParamSpec((B, K, S, hd),
                           ("batch", "kv_heads", "kv_seq", "head_dim"),
                           cfg.dtype, init="zeros", resolve_order=(0, 2, 1, 3))
    cache_abs = _sds((B, K, S, hd), cfg.dtype)

    def fn(x, layer, kc, vc, pos):
        return LM.layer_decode(x, layer, kc, vc, pos, cfg, attention="plain")

    return Cell(arch.name, shape_name, "probe_decode", fn,
                (x_abs, layer_abs, cache_abs, cache_abs, S - 1),
                (_batch_sharding_fn(2, B), layer_specs, cache_spec,
                 cache_spec, None))


def lm_device_terms(arch: "ArchDef", shape_name: str, mesh,
                    rules: Optional[ShardingRules] = None,
                    cfg_overrides: Optional[Dict] = None, **cell_kw
                    ) -> Tuple[int, Dict[str, int], str]:
    """(peak bytes, collectives, notes) of one device for an LM cell at
    its config's depth L, from the cell's DTensor runs
    (``Cell.distributed``) at 2 and 3 layers:

        X(L) = X(2) + (L - 2) · (X(3) - X(2))

    The layers are identical and run in sequence, so each adds the same
    collectives, and, under ``remat`` or with a cache, the same bytes to
    what the step holds at its peak: the reference's layer correction
    (``apply_layer_correction``) by the same linearity.  From the second
    layer on: the first can set another peak (a narrow config's step
    peaks where its one layer's backward meets the loss's).  The tests
    hold both terms against the full run at 4 layers.  A cell of at most
    3 layers runs at its depth."""
    rules = rules or ShardingRules()
    L = _lm_cfg(arch, LM_SHAPES[shape_name], cfg_overrides).n_layers
    runs = []
    for n in ((L,) if L <= 3 else (2, 3)):
        cell = arch.cell(shape_name, cfg_overrides=dict(cfg_overrides or {},
                                                        n_layers=n),
                         **cell_kw)
        ins, outs = cell.shardings(mesh, rules)
        runs.append(cell.distributed(mesh, rules, ins, outs))
    if L <= 3:
        return runs[0]
    (p2, c2, notes), (p3, c3, _) = runs
    coll = {k: c2.get(k, 0) + (L - 2) * (c3.get(k, 0) - c2.get(k, 0))
            for k in set(c2) | set(c3)}
    return p2 + (L - 2) * (p3 - p2), coll, notes


def _weights(specs: Dict, params, device) -> Dict:
    """Bridged weights when ``params`` is given, else native ones from
    ``torch.Generator().manual_seed(0)``."""
    return load_weights(specs, 0, params=params, device=device)[0]


def _lm_smoke(arch: "ArchDef"):
    cfg: LM.LMConfig = arch.config
    small = replace(cfg, n_layers=2,
                    d_model=max(64, cfg.head_dim * min(cfg.n_heads, 4)),
                    n_heads=min(cfg.n_heads, 4),
                    n_kv_heads=min(cfg.n_kv_heads,
                                   max(1, min(cfg.n_heads, 4) // 2)),
                    d_head=min(cfg.head_dim, 32), d_ff=128,
                    vocab_size=512, vocab_pad_multiple=128,
                    n_experts=min(cfg.n_experts, 4) if cfg.is_moe else 0,
                    top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
                    dtype=torch.float32, remat="none")

    def run(params=None, tokens=None, device=None):
        """``tokens`` [2, 16] (default drawn from
        ``torch.Generator().manual_seed(1)``)."""
        dev = resolve_device(device)
        p = _weights(LM.param_specs(small), params, dev)
        if tokens is None:
            tokens = torch.randint(0, small.vocab_size, (2, 16),
                                   generator=torch.Generator().manual_seed(1))
        toks = torch.as_tensor(np.array(tokens)).to(dev)
        logits, _ = LM.forward(p, toks, small)
        loss = LM.causal_lm_loss(p, {"tokens": toks, "labels": toks}, small)
        lg, cache = LM.prefill(p, toks, small, max_len=24)
        lg2, _ = LM.decode_one(p, cache, toks[:, -1], 16, small)
        return {"logits": logits, "loss": loss, "prefill_logits": lg,
                "decode_logits": lg2}

    return small, run


def lm_arch(name: str, cfg: LM.LMConfig, source: str = "",
            notes: str = "") -> ArchDef:
    return ArchDef(name, "lm", cfg, source, notes,
                   cell_builder=_lm_cell, smoke_builder=_lm_smoke)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_cell(arch: "ArchDef", shape_name: str) -> Cell:
    sh = GNN_SHAPES[shape_name]
    cfg: GCN.GCNConfig = replace(arch.config, d_feat=sh["d_feat"],
                                 n_classes=sh["n_classes"])
    specs = GCN.gcn_param_specs(cfg)
    params_abs = abstract_params(specs)
    opt_specs = {"adam": adamw_state_specs(specs)}
    opt_abs = abstract_params(opt_specs)

    if sh["kind"] == "train":
        Np = _pad_to(sh["n_nodes"], 512)
        Ep = _pad_to(sh["n_edges"], 512)
        step_fn, _ = make_train_step(
            lambda p, b: GCN.gcn_full_graph_loss(p, b, cfg), AdamWConfig())
        batch_abs = {"feats": _sds((Np, cfg.d_feat), torch.float32),
                     "src": _sds((Ep,)), "dst": _sds((Ep,)),
                     "deg": _sds((Np,), torch.float32),
                     "labels": _sds((Np,)),
                     "label_mask": _sds((Np,), torch.float32)}

        def bsh(mesh, rules):
            node = rules.spec_for((Np,), ("nodes",), mesh)
            node2 = rules.spec_for((Np, cfg.d_feat), ("nodes", None), mesh)
            edge = rules.spec_for((Ep,), ("edges",), mesh)
            return {"feats": node2, "src": edge, "dst": edge, "deg": node,
                    "labels": node, "label_mask": node}

        return Cell(arch.name, shape_name, "train", step_fn,
                    (params_abs, opt_abs, batch_abs),
                    (specs, opt_specs, bsh),
                    out_spec_trees=(specs, opt_specs, None),
                    donate_argnums=(0, 1))

    if sh["kind"] == "train_sampled":
        B = sh["batch_nodes"]
        f1, f2 = sh["fanouts"]
        step_fn, _ = make_train_step(
            lambda p, b: GCN.gcn_sampled_loss(p, b, cfg), AdamWConfig())
        F = cfg.d_feat
        batch_abs = {"feats_hop0": _sds((B, F), torch.float32),
                     "feats_hop1": _sds((B, f1, F), torch.float32),
                     "feats_hop2": _sds((B, f1, f2, F), torch.float32),
                     "labels": _sds((B,))}
        batch_fn = _batch_tree_fn({k: (s.dim(), B) for k, s in
                                   batch_abs.items()})
        return Cell(arch.name, shape_name, "train", step_fn,
                    (params_abs, opt_abs, batch_abs),
                    (specs, opt_specs, batch_fn),
                    out_spec_trees=(specs, opt_specs, None),
                    donate_argnums=(0, 1))

    # molecule: batched small graphs
    G, N, E = sh["batch"], sh["n_nodes"], sh["n_edges"]
    step_fn, _ = make_train_step(
        lambda p, b: GCN.gcn_molecule_loss(p, b, cfg), AdamWConfig())
    batch_abs = {"feats": _sds((G, N, cfg.d_feat), torch.float32),
                 "src": _sds((G, E)), "dst": _sds((G, E)),
                 "deg": _sds((G, N), torch.float32), "labels": _sds((G,))}
    batch_fn = _batch_tree_fn({k: (s.dim(), G)
                               for k, s in batch_abs.items()})
    return Cell(arch.name, shape_name, "train", step_fn,
                (params_abs, opt_abs, batch_abs),
                (specs, opt_specs, batch_fn),
                out_spec_trees=(specs, opt_specs, None),
                donate_argnums=(0, 1))


def _gnn_smoke(arch: "ArchDef"):
    cfg = replace(arch.config, d_feat=32, n_classes=7)

    def run(params=None, device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        p = _weights(GCN.gcn_param_specs(cfg), params, dev)
        N, E = 64, 256
        src = rng.integers(0, N, E)
        dst = rng.integers(0, N, E)

        def t(a, dt):
            return torch.as_tensor(np.asarray(a), dtype=dt).to(dev)
        batch = {"feats": t(rng.normal(size=(N, 32)), torch.float32),
                 "src": t(src, torch.int32), "dst": t(dst, torch.int32),
                 "deg": t(np.bincount(dst, minlength=N) + 1, torch.float32),
                 "labels": t(rng.integers(0, 7, N), torch.int32),
                 "label_mask": torch.ones(N, dtype=torch.float32,
                                          device=dev)}
        loss = GCN.gcn_full_graph_loss(p, batch, cfg)
        logits = GCN.gcn_full_graph_logits(p, batch["feats"], batch["src"],
                                           batch["dst"], batch["deg"], cfg)
        return {"loss": loss, "logits": logits}

    return cfg, run


def gnn_arch(name: str, cfg: GCN.GCNConfig, source: str = "",
             notes: str = "") -> ArchDef:
    return ArchDef(name, "gnn", cfg, source, notes,
                   cell_builder=_gnn_cell, smoke_builder=_gnn_smoke)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_batch_abs(cfg: RS.RecsysConfig, B: int) -> Dict:
    if cfg.kind in ("dlrm", "dcn"):
        return {"dense": _sds((B, cfg.n_dense), torch.float32),
                "sparse": _sds((B, cfg.n_sparse)),
                "labels": _sds((B,))}
    if cfg.kind == "mind":
        return {"hist_ids": _sds((B, cfg.hist_len)),
                "hist_mask": _sds((B, cfg.hist_len), torch.float32),
                "target_ids": _sds((B,))}
    if cfg.kind == "two_tower":
        return {"user_ids": _sds((B,)), "item_ids": _sds((B,))}
    raise ValueError(cfg.kind)


def _dim0_tree_fn(batch_abs: Dict):
    return _batch_tree_fn({k: (s.dim(), s.shape[0])
                           for k, s in batch_abs.items()})


def _recsys_cell(arch: "ArchDef", shape_name: str) -> Cell:
    sh = RECSYS_SHAPES[shape_name]
    cfg: RS.RecsysConfig = arch.config
    specs = RS.recsys_param_specs(cfg)
    params_abs = abstract_params(specs)

    if sh["kind"] == "train":
        B = sh["batch"]
        step_fn, _ = make_train_step(
            lambda p, b: RS.recsys_train_loss(p, b, cfg), AdamWConfig())
        opt_specs = {"adam": adamw_state_specs(specs)}
        batch_abs = _recsys_batch_abs(cfg, B)
        batch_fn = _batch_tree_fn({k: (s.dim(), B)
                                   for k, s in batch_abs.items()})
        return Cell(arch.name, shape_name, "train", step_fn,
                    (params_abs, abstract_params(opt_specs), batch_abs),
                    (specs, opt_specs, batch_fn),
                    out_spec_trees=(specs, opt_specs, None),
                    donate_argnums=(0, 1))

    if sh["kind"] == "serve":
        B = sh["batch"]
        if cfg.kind == "two_tower":   # score user against the paired item
            batch_abs = {"user_ids": _sds((B,)), "cand_ids": _sds((B,))}

            def fn(p, b):
                return RS.two_tower_retrieval_scores(p, b, cfg)
        else:
            batch_abs = _recsys_batch_abs(cfg, B)

            def fn(p, b):
                return RS.recsys_serve(p, b, cfg)
        return Cell(arch.name, shape_name, "serve", fn,
                    (params_abs, batch_abs), (specs, _dim0_tree_fn(batch_abs)))

    # retrieval_cand: one query scored against n_candidates
    N = sh["n_candidates"]
    if cfg.kind == "two_tower":
        batch_abs = {"user_ids": _sds((1,)), "cand_ids": _sds((N,))}

        def fn(p, b):
            return RS.two_tower_retrieval_scores(p, b, cfg)
    elif cfg.kind == "mind":
        batch_abs = {"hist_ids": _sds((1, cfg.hist_len)),
                     "hist_mask": _sds((1, cfg.hist_len), torch.float32),
                     "target_ids": _sds((N,))}

        def fn(p, b):
            u = RS.mind_interests(p, b["hist_ids"], b["hist_mask"], cfg)
            t = RS._take(p["item_embed"], b["target_ids"])
            return torch.einsum("qkd,nd->qkn", u, t).amax(dim=1)
    else:   # dlrm/dcn: broadcast one user over N candidate rows
        batch_abs = _recsys_batch_abs(cfg, N)
        batch_abs.pop("labels")
        forward = RS.dlrm_forward if cfg.kind == "dlrm" else RS.dcn_forward

        def fn(p, b):
            return torch.sigmoid(forward(p, b, cfg))
    return Cell(arch.name, shape_name, "serve", fn,
                (params_abs, batch_abs), (specs, _dim0_tree_fn(batch_abs)))


def _recsys_smoke(arch: "ArchDef"):
    cfg: RS.RecsysConfig = arch.config
    embed_small = min(cfg.embed_dim, 8)
    small = replace(
        cfg,
        vocab_sizes=tuple(min(v, 64) for v in cfg.vocab_sizes),
        embed_dim=embed_small,
        # DLRM invariant: bottom-MLP output dim == embed_dim
        bot_mlp=(tuple(min(x, 16) for x in cfg.bot_mlp[:-1])
                 + (embed_small,)) if cfg.bot_mlp else (),
        top_mlp=tuple(min(x, 16) for x in cfg.top_mlp),
        deep_mlp=tuple(min(x, 16) for x in cfg.deep_mlp),
        tower_mlp=tuple(min(x, 16) for x in cfg.tower_mlp),
        item_vocab=min(cfg.item_vocab, 128),
        user_vocab=min(cfg.user_vocab, 128),
        hist_len=min(cfg.hist_len, 8))

    def run(params=None, device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        p = _weights(RS.recsys_param_specs(small), params, dev)
        B = 16

        def t(a, dt):
            return torch.as_tensor(np.asarray(a), dtype=dt).to(dev)
        if small.kind in ("dlrm", "dcn"):
            batch = {"dense": t(rng.normal(size=(B, small.n_dense)),
                                torch.float32),
                     "sparse": t(rng.integers(0, min(small.vocab_sizes),
                                              (B, small.n_sparse)),
                                 torch.int32),
                     "labels": t(rng.integers(0, 2, B), torch.int32)}
        elif small.kind == "mind":
            batch = {"hist_ids": t(rng.integers(0, small.item_vocab,
                                                (B, small.hist_len)),
                                   torch.int32),
                     "hist_mask": torch.ones((B, small.hist_len),
                                             dtype=torch.float32, device=dev),
                     "target_ids": t(rng.integers(0, small.item_vocab, B),
                                     torch.int32)}
        else:
            batch = {"user_ids": t(rng.integers(0, small.user_vocab, B),
                                   torch.int32),
                     "item_ids": t(rng.integers(0, small.item_vocab, B),
                                   torch.int32)}
        loss = RS.recsys_train_loss(p, batch, small)
        if small.kind == "two_tower":
            serve = RS.recsys_serve(p, {"user_ids": batch["user_ids"][:1],
                                        "cand_ids": batch["item_ids"]}, small)
        else:
            serve = RS.recsys_serve(p, batch, small)
        return {"loss": loss, "serve": serve}

    return small, run


def recsys_arch(name: str, cfg: RS.RecsysConfig, source: str = "",
                notes: str = "") -> ArchDef:
    return ArchDef(name, "recsys", cfg, source, notes,
                   cell_builder=_recsys_cell, smoke_builder=_recsys_smoke)
