"""Shared model machinery: parameter specs, initialisation, the weight
bridge and the numerics the models share.

Counterpart of ``repro.models.common``.  Parameters are nested dicts of
tensors in the reference's layout (``wq [L, D, H, hd]``,
``wo [L, H, hd, D]``, ...), so ``params_from_numpy`` can take the
reference's parameter tree and both packages compute from identical
weights.  Native initialisation draws from a ``torch.Generator``; it
cannot reproduce the reference's ``jax.random`` bits.

Inside ``activation_sharding(mesh, spec_fn)``, ``shard_act`` pins a
``DTensor`` activation to the placements the rules give its logical
axes (``DTensor.redistribute``); a plain tensor passes through
unchanged, so a model on one card computes the same in or out of the
context.  A tensor a model builds inside a step (a rope table, an index,
a mask) joins a DTensor activation as a replica on its mesh
(``replicate_like``); on plain tensors that too is the identity.  A
redistribution a model makes beyond the rules' (``note_act``) is named
in the notes of ``act_notes``.
"""
from __future__ import annotations

import contextlib
import hashlib
import math
import sys
import threading
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ParamSpec", "init_params", "abstract_params", "logical_axes_tree",
           "count_params", "params_digest", "params_from_numpy", "rms_norm",
           "rope", "shard_act", "activation_sharding", "act_notes",
           "note_act", "replicate_like", "split_dim", "is_dtensor",
           "zeros_act", "on_replicas", "take_rows", "logsumexp",
           "diagonal", "gather_rows", "scatter_add_rows", "matmul",
           "linear", "is_split", "plain",
           "he_init",
           "lecun_init", "embed_init", "zeros_init", "ones_init",
           "load_weights"]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "lecun"          # lecun | he | embed | zeros | ones | normal
    init_scale: float = 1.0
    #: the order in which the dims claim mesh axes (``distrib.shardings``);
    #: None is first to last
    resolve_order: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"{self.shape} vs {self.logical_axes}")
        if self.resolve_order is not None and \
                sorted(self.resolve_order) != list(range(len(self.shape))):
            raise ValueError(f"resolve_order {self.resolve_order} is not a "
                             f"permutation of {len(self.shape)} dims")


he_init = partial(ParamSpec, init="he")
lecun_init = partial(ParamSpec, init="lecun")
embed_init = partial(ParamSpec, init="embed")
zeros_init = partial(ParamSpec, init="zeros")
ones_init = partial(ParamSpec, init="ones")


def _std(spec: ParamSpec) -> float:
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    if spec.init in ("embed", "normal"):
        return spec.init_scale
    if spec.init == "he":
        return spec.init_scale * math.sqrt(2.0 / fan_in)
    if spec.init == "lecun":
        return spec.init_scale * math.sqrt(1.0 / fan_in)
    raise ValueError(f"unknown init {spec.init!r}")


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in sorted-key order, the order jax.tree uses."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.extend(_leaves(val, prefix + (key,)))
        else:
            out.append((prefix + (key,), val))
    return out


def _unflatten(pairs) -> Dict:
    out: Dict = {}
    for path, val in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return out


def init_params(specs: Dict, generator: torch.Generator,
                device: Union[str, torch.device]) -> Dict:
    """Materialise a spec tree.  Draws on the generator's device (the
    CPU for a default ``torch.Generator``) in sorted-key order, then
    moves each tensor to ``device``, so the weights do not depend on
    the device they land on.  A CUDA generator draws on the card, which
    keeps multi-GB embedding tables off the host."""
    vals, gdev = [], generator.device
    for path, spec in _leaves(specs):
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=spec.dtype, device=device)
        else:
            t = torch.randn(spec.shape, generator=generator, device=gdev,
                            dtype=torch.float32)
            t = t.mul_(_std(spec)).to(device=device, dtype=spec.dtype)
        vals.append((path, t))
    return _unflatten(vals)


def abstract_params(specs: Dict) -> Dict:
    """The spec tree as tensors on the ``meta`` device: shapes and dtypes,
    no memory (the reference's ``ShapeDtypeStruct`` tree)."""
    return _unflatten((path, torch.empty(spec.shape, dtype=spec.dtype,
                                         device="meta"))
                      for path, spec in _leaves(specs))


def logical_axes_tree(specs: Dict) -> Dict:
    return _unflatten((path, spec.logical_axes)
                      for path, spec in _leaves(specs))


def count_params(specs: Dict) -> int:
    return sum(math.prod(spec.shape) for _, spec in _leaves(specs))


def _tensor_of(leaf) -> torch.Tensor:
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: torch cannot take it
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree: Dict, device: Union[str, torch.device]) -> Dict:
    """The weight bridge: a nested dict of arrays (the reference's
    parameter tree, converted with ``np.asarray``) -> the same nested
    dict of tensors on ``device``, layout and dtype unchanged (bf16
    arrays of ``ml_dtypes`` included)."""
    return _unflatten((path, _tensor_of(leaf).to(device))
                      for path, leaf in _leaves(tree))


def load_weights(specs: Dict, seed: int = 0, *,
                 params: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None
                 ) -> Tuple[Dict, Tuple]:
    """(weights on the device, their source) for a spec tree: ``params``,
    a nested dict of numpy arrays in the reference's layout, bridged
    with ``params_from_numpy`` (source ``("numpy-sha256", digest)``);
    without it, drawn from ``torch.Generator().manual_seed(seed)`` on
    the host (source ``("torch.Generator", seed)``)."""
    dev = resolve_device(device)
    if params is None:
        return (init_params(specs, torch.Generator().manual_seed(seed), dev),
                ("torch.Generator", int(seed)))
    return (params_from_numpy(params, dev),
            ("numpy-sha256", params_digest(params)))


def params_digest(tree: Dict) -> str:
    """sha256 (hex) of a nested dict of arrays: every leaf's path, dtype,
    shape and bytes in sorted-key order.  Names bridged weights in
    provenance fingerprints."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        arr = np.ascontiguousarray(np.asarray(leaf))
        h.update(repr((path, arr.dtype.str, arr.shape)).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation of the mean square, applied in
    ``x``'s dtype (as ``repro.models.common.rms_norm``)."""
    var = x.square().mean(dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding. x: [..., seq, heads, d_head].

    cos/sin are computed in fp32 (tiny [S, d/2] tables), then applied in
    the activation's dtype, as ``repro.models.common.rope`` does."""
    half = x.shape[-1] // 2
    freq = (1.0 / base) ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    angles = positions.to(device=x.device, dtype=torch.float32)[..., None] \
        * freq                                            # [..., S, half]
    cos = replicate_like(torch.cos(angles)[..., None, :].to(x.dtype), x)
    sin = replicate_like(torch.sin(angles)[..., None, :].to(x.dtype), x)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


_ACT_CTX = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh, spec_fn):
    """Within the context, ``shard_act`` pins DTensor activations on
    ``mesh`` to ``spec_fn(shape, logical_axes, mesh)`` (a spec, as
    ``distrib.shardings.ShardingRules.spec_for`` returns).  The context
    is per thread, as the reference's is."""
    prev = getattr(_ACT_CTX, "value", None)
    _ACT_CTX.value = (mesh, spec_fn)
    try:
        yield
    finally:
        _ACT_CTX.value = prev


def shard_act(x: torch.Tensor, logical_axes) -> torch.Tensor:
    """``x`` redistributed to the placements of its logical axes when it
    is a ``DTensor`` inside ``activation_sharding``; else ``x`` itself."""
    ctx = getattr(_ACT_CTX, "value", None)
    if ctx is None or not is_dtensor(x):
        return x
    from ..distrib.shardings import placements_for
    mesh, spec_fn = ctx
    spec = spec_fn(tuple(x.shape), tuple(logical_axes), mesh)
    return x.redistribute(mesh, placements_for(spec, mesh))


@contextlib.contextmanager
def act_notes():
    """Collects, in the list it yields, the notes ``note_act`` makes in
    this thread while the context is open."""
    prev = getattr(_ACT_CTX, "notes", None)
    _ACT_CTX.notes = notes = []
    try:
        yield notes
    finally:
        _ACT_CTX.notes = prev


def note_act(text: str) -> None:
    """Record ``text`` in the open ``act_notes`` (if any)."""
    notes = getattr(_ACT_CTX, "notes", None)
    if notes is not None:
        notes.append(text)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (without importing DTensor: none
    exists before ``torch.distributed.tensor`` is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def replicate_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    ``DTensor``; else ``t`` itself."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def split_dim(x: torch.Tensor, dim: int, sizes: Tuple[int, ...],
              what: str = "") -> torch.Tensor:
    """``x.unflatten(dim, sizes)``.  A ``DTensor`` split on ``dim`` over
    mesh axes that ``sizes[0]`` does not divide is gathered on those axes
    first (DTensor cannot split a dim unevenly; XLA pads it instead),
    and the gather is named in ``note_act``'s notes."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        d = dim % x.ndim
        mesh = x.device_mesh
        placements, split, gathered = list(x.placements), 1, []
        for i, p in enumerate(placements):
            if isinstance(p, Shard) and p.dim == d:
                if sizes[0] % (split * mesh.size(i)):
                    placements[i] = Replicate()
                    gathered.append(mesh.mesh_dim_names[i])
                else:
                    split *= mesh.size(i)
        if gathered:
            note_act(f"{what or 'dim'} {sizes[0]} not divisible over "
                     f"{'+'.join(gathered)}: gathered before the split")
            x = x.redistribute(mesh, placements)
    return x.unflatten(dim, sizes)


def zeros_act(shape, dtype: torch.dtype, logical_axes, like,
              order=None) -> torch.Tensor:
    """Zeros of ``shape`` on ``like``'s device; inside
    ``activation_sharding`` with ``like`` a ``DTensor``, a DTensor of
    local zeros placed as the rules place ``logical_axes`` (claimed in
    ``order``), so no device holds the whole."""
    ctx = getattr(_ACT_CTX, "value", None)
    if ctx is None or not is_dtensor(like):
        return torch.zeros(tuple(shape), dtype=dtype, device=like.device)
    from torch.distributed.tensor import DTensor
    from ..distrib.shardings import local_shape, placements_for
    mesh, spec_fn = ctx
    spec = spec_fn(tuple(shape), tuple(logical_axes), mesh) if order is None \
        else spec_fn(tuple(shape), tuple(logical_axes), mesh, order)
    local = torch.zeros(local_shape(shape, spec, mesh), dtype=dtype,
                        device=like.device)
    return DTensor.from_local(local, mesh, placements_for(spec, mesh),
                              run_check=False, shape=tuple(shape),
                              stride=_strides(shape))


def _strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for s in reversed(tuple(shape)):
        out.append(n)
        n *= int(s)
    return tuple(reversed(out))


def on_replicas(fn, *args):
    """``fn(*args)`` where DTensors are among ``args`` (tensors, or dicts
    of them): each is gathered to a replica (an all-gather, counted),
    ``fn`` runs on the local tensors, identical on every device, and its
    tensor outputs return as replicated DTensors.  For the ops that have
    no sharding strategy (a global sort, scatters into a dispatch
    buffer).  Gradients flow through both ends."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(a.device_mesh for a in _flat(args) if is_dtensor(a))
    rep = (Replicate(),) * mesh.ndim

    def local(a):
        if isinstance(a, dict):
            return {k: local(v) for k, v in a.items()}
        return a.redistribute(mesh, rep).to_local() if is_dtensor(a) else a

    def back(o):
        if isinstance(o, (tuple, list)):
            return type(o)(back(v) for v in o)
        return DTensor.from_local(o, mesh, rep, run_check=False) \
            if isinstance(o, torch.Tensor) else o
    return back(fn(*(local(a) for a in args)))


def is_split(*xs) -> bool:
    """Whether any of ``xs`` is a DTensor split or partial over a mesh
    dim (a replica on every dim is not)."""
    if not any(is_dtensor(x) for x in xs):
        return False
    from torch.distributed.tensor import Replicate
    return any(is_dtensor(x) and not all(isinstance(p, Replicate)
                                         for p in x.placements) for x in xs)


def plain(fn, *args):
    """``fn(*args)``; where replicated DTensors are among ``args``, on
    their local tensors (``on_replicas``): the plain ops, so a one-device
    mesh runs what a card runs, and none of DTensor's strategies."""
    if any(is_dtensor(a) for a in _flat(args)):
        return on_replicas(fn, *args)
    return fn(*args)


def _flat(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _flat(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _flat(v)
    else:
        yield x


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0, mode="clip")``; on DTensors through
    ``gather_rows``."""
    return gather_rows(table, ids.long().clamp(0, table.shape[0] - 1))


class _GatherRows(torch.autograd.Function):
    """``x[idx]`` of a DTensor ``x`` (rows indexed by ``idx``, a DTensor
    of ints) by explicit redistributions and local ops, its backward too.
    DTensor's own strategies for a gather of split rows (``aten.index``,
    ``aten.embedding``) and for their backward (``index_put``, a masked
    partial sum) are missing or fail on some torch versions.

    Two plans, the one that moves fewer bytes (XLA's choice too):
    ``"gather"`` all-gathers ``x``'s rows and looks up each device's ids
    locally; ``"mask"`` gathers the ids, each device looks up the rows it
    holds (the others zero), and the partial rows are summed into the
    ids' placement.  The backward adds the gradient rows into zeros and
    reduces them into ``x``'s placement."""

    @staticmethod
    def forward(ctx, x, idx, plan: str):
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh, nd = x.device_mesh, idx.ndim
        xp, ip = x.placements, idx.placements
        row = [isinstance(p, Shard) and p.dim == 0 for p in xp]
        col = [isinstance(p, Shard) and p.dim > 0 for p in xp]
        # ids: replicated where x's columns (and, "mask", its rows) split
        it = tuple(Replicate() if c or (r and plan == "mask") else p
                   for p, r, c in zip(ip, row, col))
        idx_l = idx.redistribute(mesh, it).to_local()
        if plan == "gather":
            xt = tuple(Replicate() if r else p for p, r in zip(xp, row))
            x_l = x.redistribute(mesh, xt).to_local()
            at, hit = idx_l, None
            out = x_l[at]
        else:
            x_l = x.to_local()
            coord, k = mesh.get_coordinate(), 0
            for i in range(mesh.ndim):
                if row[i]:
                    k = k * mesh.size(i) + coord[i]
            at = idx_l - k * x_l.shape[0]
            hit = (at >= 0) & (at < x_l.shape[0])
            at = at.clamp(0, x_l.shape[0] - 1)
            out = x_l[at] * hit.view(hit.shape + (1,) * (x_l.ndim - 1)
                                     ).to(x_l.dtype)
        split = tuple(Shard(nd + p.dim - 1) if c else q
                      for p, c, q in zip(xp, col, it))
        shape = tuple(idx.shape) + tuple(x.shape[1:])
        out = DTensor.from_local(
            out, mesh, tuple(Partial() if r and plan == "mask" else q
                             for r, q in zip(row, split)),
            run_check=False, shape=shape, stride=_strides(shape))
        final = tuple(p if r and plan == "mask" else q
                      for p, r, q in zip(ip, row, split))
        ctx.plan, ctx.row, ctx.col, ctx.it = plan, row, col, it
        ctx.xp, ctx.split, ctx.mesh = xp, split, mesh
        ctx.x_shape, ctx.x_global = tuple(x_l.shape), tuple(x.shape)
        ctx.save_for_backward(at, *(() if hit is None else (hit,)))
        return out.redistribute(mesh, final)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        at, *hit = ctx.saved_tensors
        g_l = g.redistribute(ctx.mesh, ctx.split).to_local()
        if hit:
            g_l = g_l * hit[0].view(hit[0].shape + (1,) * (g_l.ndim
                                                           - hit[0].ndim)
                                    ).to(g_l.dtype)
        gx = torch.zeros(ctx.x_shape, dtype=g_l.dtype, device=g_l.device)
        gx.index_put_((at,), g_l, accumulate=True)
        # each device holds the sum over its ids: partial where they split
        gp = tuple(
            p if c else
            (ctx.xp[i] if ctx.plan == "mask" and ctx.row[i] else
             Partial() if not isinstance(ctx.it[i], Replicate)
             else Replicate())
            for i, (p, c) in enumerate(zip(ctx.xp, ctx.col)))
        gx = DTensor.from_local(gx, ctx.mesh, gp, run_check=False,
                                shape=ctx.x_global,
                                stride=_strides(ctx.x_global))
        return gx.redistribute(ctx.mesh, ctx.xp), None, None


def logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.logsumexp(x, dim)``; on a DTensor as a max and a sum of
    exponentials, which reduce a split ``dim`` by partial results (DTensor
    has no strategy that splits ``logsumexp``'s dim: it gathers it)."""
    if not is_split(x):
        return plain(lambda t: torch.logsumexp(t, dim=dim), x)
    m = x.amax(dim=dim, keepdim=True).detach()
    return (m + torch.log(torch.exp(x - m).sum(dim=dim, keepdim=True))
            ).squeeze(dim)


def _iota_like(x, dim: int):
    """``arange(x.shape[dim])`` as a DTensor split as ``x`` splits
    ``dim`` (a replica elsewhere)."""
    from torch.distributed.tensor import Replicate, Shard
    d = dim % x.ndim
    t = replicate_like(torch.arange(x.shape[d], device=x.device), x)
    return t.redistribute(x.device_mesh, tuple(
        Shard(0) if isinstance(p, Shard) and p.dim == d else Replicate()
        for p in x.placements))


def diagonal(x: torch.Tensor) -> torch.Tensor:
    """``torch.diagonal(x)`` of a square matrix; on a DTensor as a masked
    row sum, the mask split as ``x`` is (DTensor has no strategy for
    ``diagonal``'s backward)."""
    if not is_split(x):
        return plain(torch.diagonal, x)
    eye = _iota_like(x, 0)[:, None] == _iota_like(x, 1)[None, :]
    return torch.where(eye, x, 0.0).sum(dim=-1)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (rows of ``x`` by an int tensor); on a DTensor ``x``
    through ``_GatherRows``, its plan the one that moves fewer bytes:
    gather ``x`` when it holds no more elements than the result, else
    look the rows up where they lie."""
    if not is_dtensor(x):
        return x[idx]
    idx = replicate_like(idx, x)
    if not is_split(x, idx):
        return plain(lambda t, i: t[i], x, idx)
    n_out = idx.numel() * math.prod(x.shape[1:])
    return _GatherRows.apply(x, idx, "gather" if x.numel() <= n_out
                             else "mask")


class _ScatterAddRows(torch.autograd.Function):
    """``zeros_like(like).index_add(0, idx, src)`` for DTensors by
    explicit redistributions and local ops: each device adds its ``src``
    rows into zeros of every row, and the partial sums are reduced into
    ``like``'s placement.  The backward gathers the gradient's rows and
    looks up each device's."""

    @staticmethod
    def forward(ctx, like, idx, src):
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh, lp = like.device_mesh, like.placements
        row = [isinstance(p, Shard) and p.dim == 0 for p in lp]
        col = [isinstance(p, Shard) and p.dim > 0 for p in lp]
        # src: split as like's columns; its rows as the ids'
        ip = tuple(Replicate() if c else p
                   for p, c in zip(idx.placements, col))
        sp = tuple(Shard(idx.ndim + p.dim - 1) if c else q
                   for p, c, q in zip(lp, col, ip))
        idx_l = idx.redistribute(mesh, ip).to_local()
        src_l = src.redistribute(mesh, sp).to_local()
        shape = tuple(like.shape)
        local = [shape[0]] + list(src_l.shape[idx.ndim:])
        out = torch.zeros(local, dtype=src_l.dtype, device=src_l.device)
        out.index_add_(0, idx_l.reshape(-1),
                       src_l.reshape((-1,) + tuple(local[1:])))
        out = DTensor.from_local(
            out, mesh, tuple(p if c else
                             Partial() if isinstance(q, Shard)
                             else Replicate()
                             for p, c, q in zip(lp, col, ip)),
            run_check=False, shape=shape, stride=_strides(shape))
        ctx.save_for_backward(idx_l)
        ctx.mesh, ctx.lp, ctx.sp, ctx.col = mesh, lp, sp, col
        ctx.src_placements = src.placements
        ctx.src_shape = tuple(src.shape)
        return out.redistribute(mesh, lp)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate
        idx_l, = ctx.saved_tensors
        g_l = g.redistribute(ctx.mesh, tuple(
            p if c else Replicate() for p, c in zip(ctx.lp, ctx.col))
        ).to_local()
        gs = g_l[idx_l]
        gs = DTensor.from_local(gs, ctx.mesh, ctx.sp, run_check=False,
                                shape=ctx.src_shape,
                                stride=_strides(ctx.src_shape))
        return None, None, gs.redistribute(ctx.mesh, ctx.src_placements)


def scatter_add_rows(like: torch.Tensor, idx: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """``torch.zeros_like(like).index_add(0, idx, src)``; on DTensors
    through ``_ScatterAddRows``."""
    if not is_split(like, idx, src):
        return plain(lambda t, i, v: torch.zeros_like(t).index_add(0, i, v),
                     like, idx, src)
    return _ScatterAddRows.apply(like, replicate_like(idx, like),
                                 replicate_like(src, like))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w 2-D); on DTensors as an einsum, which DTensor places
    as a batched product: its ``mm`` strategy asks some torch versions
    for a redistribution from a split to a partial sum that they cannot
    run."""
    if not is_split(x, w):
        return plain(lambda a, b: a @ b, x, w)
    return torch.einsum("...i,ij->...j", x, w)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``; on DTensors through ``matmul``, the bias gathered to
    a replica first (its broadcast add, a split bias on a split product,
    asks some torch versions for a redistribution from a split to a
    partial sum that they cannot run)."""
    if not is_split(x, w, b):
        return plain(lambda a, c, d: a @ c + d, x, w, b)
    from torch.distributed.tensor import Replicate
    return matmul(x, w) + b.redistribute(
        b.device_mesh, (Replicate(),) * b.device_mesh.ndim)
