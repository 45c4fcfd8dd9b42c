"""Logical-axis sharding rules with divisibility pruning.

Counterpart of ``repro.distrib.shardings``.  Every parameter and
activation dim carries a *logical* axis name; a rule table maps logical
axes to mesh axes.  One rule set covers all 10 architectures × 4 shapes
× 2 meshes, so infeasible assignments are pruned instead of failing:

* a mesh axis is used at most once per array; the first dim (in
  resolution order) wins, later dims fall back;
* if a dim is not divisible by its mesh-axis product, trailing mesh axes
  are dropped until it divides (40 attention heads on a 16-way model
  axis: heads replicated, tensor parallelism falls back to ``d_ff``);
* unknown logical axes replicate; ``"pod"`` is skipped on 2-D meshes.

A spec is the port's own ``PartitionSpec``: a tuple with one entry per
dim, each a mesh axis name, a tuple of names (joint sharding) or
``None``, trailing ``None``s stripped.  ``placements_for`` turns one
into DTensor placements (``Shard(d)`` or ``Replicate()`` per mesh dim)
for a ``torch.distributed.device_mesh.DeviceMesh``.  The rules read a
mesh's ``mesh_dim_names`` and ``shape`` only, so any ``DeviceMesh`` (or
an object with those two attributes) will do.

A ``ParamSpec`` may carry ``resolve_order``: the order in which its dims
claim mesh axes.  The port's KV cache is head-major
(``[L, B, K, S, hd]``) where the reference's is ``[L, B, S, K, hd]``;
it resolves in the reference's order, so both packages shard it alike
on every mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..models.common import ParamSpec, _leaves, _unflatten

__all__ = ["ShardingRules", "DEFAULT_RULES", "spec_for", "tree_shardings",
           "batch_axes", "describe_tree_shardings", "mesh_sizes",
           "placements_for", "shard_bytes", "local_shape"]


#: rule table: logical axis -> tuple of mesh axes (joint sharding).
#: tuple order = preference; trailing axes pruned on indivisibility.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # LM params
    "vocab": ("model",),
    "d_ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "moe_groups": ("data",),
    "moe_capacity": ("model",),   # fallback TP when experts indivisible
    "d_model": ("data",),          # FSDP / ZeRO-3 style in-dim shard
    "d_model_out": ("data",),
    # activations
    "batch": ("pod", "data"),      # "pod" silently skipped on 2D meshes
    "seq": (),
    "kv_seq": ("model",),          # split-K decode
    # recsys
    "table_rows": ("data", "model"),
    "table_dim": (),
    "mlp_in": ("data",),
    "mlp_out": ("model",),
    # gnn
    "gnn_in": (),
    "gnn_out": (),
    "nodes": ("data", "model"),
    "edges": ("data", "model"),
    # never sharded
    "layers": (),
    "norm": (),
    "head_dim": (),
}

Spec = Tuple[Any, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """{mesh axis name: size} of a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


@dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, Tuple[str, ...]] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def override(self, **kv: Tuple[str, ...]) -> "ShardingRules":
        new = dict(self.rules)
        new.update(kv)
        return ShardingRules(new)

    # -- core resolution ---------------------------------------------------
    def spec_for(self, shape: Sequence[int],
                 logical_axes: Sequence[Optional[str]], mesh,
                 order: Optional[Sequence[int]] = None) -> Spec:
        """The spec of an array of ``shape`` on ``mesh``; its dims claim
        mesh axes in ``order`` (a permutation of the dims; default
        first to last)."""
        sizes = mesh_sizes(mesh)
        used: set = set()
        parts: List[Any] = [None] * len(shape)
        for d in (range(len(shape)) if order is None else order):
            lax = logical_axes[d]
            if lax is None:
                continue
            cand = [a for a in self.rules.get(lax, ())
                    if a in sizes and a not in used]
            # divisibility pruning: drop trailing axes until dim divides
            while cand and shape[d] % math.prod(sizes[a] for a in cand):
                cand.pop()
            if cand:
                used.update(cand)
                parts[d] = tuple(cand) if len(cand) > 1 else cand[0]
        # strip trailing Nones for a tidy spec
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def spec_of(self, spec: ParamSpec, mesh) -> Spec:
        return self.spec_for(spec.shape, spec.logical_axes, mesh,
                             spec.resolve_order)

    def tree_specs(self, specs, mesh):
        """tree[ParamSpec] (or one ParamSpec) -> tree[spec]."""
        return _map_specs(lambda s: self.spec_of(s, mesh), specs)

    def tree_shardings(self, specs, mesh):
        """tree[ParamSpec] -> tree[DTensor placements] on ``mesh``."""
        return _map_specs(
            lambda s: placements_for(self.spec_of(s, mesh), mesh), specs)


def _map_specs(fn, specs):
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return _unflatten((path, fn(s)) for path, s in _leaves(specs))


def placements_for(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` it splits, else
    ``Replicate()``; a split over an axis of one device is a replica.  A
    dim split over several mesh axes takes them in the mesh's order
    (DTensor's), so a joint spec must name them so."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's shard of an array of ``shape`` split by ``spec``
    (every split divides, as the rules ensure)."""
    sizes = mesh_sizes(mesh)
    out = [int(s) for s in shape]
    for d, part in enumerate(spec):
        if part is not None:
            for a in (part if isinstance(part, tuple) else (part,)):
                out[d] //= sizes[a]
    return tuple(out)


def shard_bytes(shape: Sequence[int], itemsize: int, spec: Spec,
                mesh) -> int:
    """Bytes one device holds of an array of ``shape`` split by
    ``spec`` (every split divides, as the rules ensure)."""
    sizes = mesh_sizes(mesh)
    n = math.prod(int(s) for s in shape)
    for part in spec:
        if part is not None:
            axes = part if isinstance(part, tuple) else (part,)
            n //= math.prod(sizes[a] for a in axes)
    return n * itemsize


def spec_for(shape, logical_axes, mesh,
             rules: Optional[ShardingRules] = None) -> Spec:
    return (rules or ShardingRules()).spec_for(shape, logical_axes, mesh)


def tree_shardings(specs, mesh, rules: Optional[ShardingRules] = None):
    return (rules or ShardingRules()).tree_shardings(specs, mesh)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that jointly shard the global batch."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _spec_text(spec: Spec) -> str:
    """The spec as the reference prints a ``PartitionSpec``."""
    return f"PartitionSpec({', '.join(repr(p) for p in spec)})"


def describe_tree_shardings(specs, mesh,
                            rules: Optional[ShardingRules] = None
                            ) -> List[str]:
    """Human-readable sharding table, one line a leaf."""
    rules = rules or ShardingRules()
    return [f"{'/'.join(path):40s} {str(s.shape):24s} "
            f"{_spec_text(rules.spec_of(s, mesh))}"
            for path, s in _leaves(specs)]
