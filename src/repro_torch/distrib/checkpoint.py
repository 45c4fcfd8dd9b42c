"""Atomic, async checkpointing of nested tensors.

Counterpart of ``repro.distrib.checkpoint``, with the same on-disk
format, so either package restores the other's checkpoints:

* **content**: every leaf of a nested structure of dicts, lists and
  tuples of tensors (or arrays, or scalars) is saved as an ``.npy``
  (``leaf_<i>.npy``), plus a JSON manifest (``step``; ``leaves`` of
  ``name``, ``file``, ``shape``, ``dtype``).  A leaf's name is its path
  as ``jax.tree_util.tree_flatten_with_path`` names it: dict keys in
  sorted order, list and tuple indices, joined by ``.``.  Dtypes numpy
  lacks (``bfloat16``, the ``float8`` types) are stored as float32 with
  the logical dtype recorded, and cast back on restore.
* **atomicity**: writes go to ``<dir>/.tmp-<step>-<pid>`` and are
  committed with a single ``os.replace`` to ``<dir>/step_<k>`` — a
  crash mid-save never corrupts the latest checkpoint; ``latest()``
  only sees committed directories.
* **async**: ``save_async`` copies the leaves to host memory, then
  writes on a background thread; ``wait()`` joins before the next save.
* **retention**: keep the newest ``keep`` checkpoints, delete older.

``restore`` puts every leaf on one ``device=`` (CUDA unless ``"cpu"``).
The elastic path is ``shardings=``, a tree shaped like ``like`` whose
leaves are ``(DeviceMesh, placements)`` pairs (``None`` for a plain
tensor): each such leaf comes back as a ``DTensor`` on the *current*
mesh, whatever mesh saved it, as the reference's tree of
``NamedSharding``s puts its leaves.  Every rank reads the whole leaf
and keeps its own shard, so the restore needs no collective.  A
``DTensor`` leaf is saved whole (``full_tensor()``).
"""
from __future__ import annotations

import collections
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint",
           "latest_step"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _dict_keys(d: dict) -> list:
    """A dict's keys in jax's flatten order: sorted, but an
    ``OrderedDict`` keeps its own order."""
    return list(d) if isinstance(d, collections.OrderedDict) else sorted(d)


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(path segment, child) of a container node, in the order
    ``jax.tree_util`` flattens it; ``None`` for a leaf.  ``None`` itself
    is a node without children, as in jax."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in _dict_keys(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_names(tree: Any) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append((".".join(path) or "leaf", node))
            return
        for seg, child in kids:
            walk(child, path + [seg])

    walk(tree, [])
    return out


def _map_leaves(tree: Any, fn: Callable[[Any], Any]) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)``, called in
    flatten order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        mapped = {k: _map_leaves(tree[k], fn) for k in _dict_keys(tree)}
        out = {k: mapped[k] for k in tree}          # the dict's own order
        return type(tree)(out) if isinstance(tree, collections.OrderedDict) \
            else out
    if _is_namedtuple(tree):
        return type(tree)(*[_map_leaves(v, fn) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


#: torch dtypes numpy holds as they are; any other is written as float32
_NUMPY_DTYPES = frozenset({
    torch.float64, torch.float32, torch.float16, torch.complex128,
    torch.complex64, torch.int64, torch.int32, torch.int16, torch.int8,
    torch.uint8, torch.bool})


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s global value; any other tensor itself."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to write, logical dtype name): numpy-less dtypes as
    float32."""
    if isinstance(leaf, torch.Tensor):
        t = _whole(leaf).detach().cpu()
        name = _dtype_name(t.dtype)
        if t.dtype not in _NUMPY_DTYPES:
            return t.float().numpy(), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind == "V" or name not in np.sctypeDict:
        arr = arr.astype(np.float32)
    return arr, name


def _snapshot(leaf: Any) -> Any:
    """A host copy the caller may not mutate afterwards."""
    if isinstance(leaf, torch.Tensor):
        return _whole(leaf).detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "time": time.time(),
                "format_version": 1}
    for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
        arr, logical_dtype = _host(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"name": name, "file": fn, "shape": list(arr.shape),
             "dtype": logical_dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)              # atomic commit
    return final


def _like_leaves(like: Any, other: Any) -> List[Any]:
    """The nodes of ``other`` at ``like``'s leaves, walking ``like``'s
    structure (so a ``(mesh, placements)`` pair stays one leaf)."""
    out: List[Any] = []

    def walk(node, o):
        if node is None:
            return
        if isinstance(node, dict):
            for k in _dict_keys(node):
                walk(node[k], o[k])
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), getattr(o, f))
        elif isinstance(node, (list, tuple)):
            for v, ov in zip(node, o):
                walk(v, ov)
        else:
            out.append(o)

    walk(like, other)
    return out


def restore_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None,
                       device: Any = None,
                       shardings: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: every leaf a tensor on
    ``device`` (CUDA unless ``"cpu"``), of the dtype of ``like``'s leaf
    where that is a tensor, else of the recorded logical dtype; with
    ``shardings`` (a tree like ``like`` of ``(DeviceMesh, placements)``
    or ``None``), each leaf that has a pair a ``DTensor`` on that mesh
    (on the mesh's device; ``device`` is then not needed).  Returns
    ``(tree, step)``."""
    shard_leaves = _like_leaves(like, shardings) if shardings is not None \
        else None
    dev = None if shard_leaves is not None and \
        all(s is not None for s in shard_leaves) else resolve_device(device)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    named = _flatten_with_names(like)
    by_name = {l["name"]: l for l in manifest["leaves"]}
    missing = [n for n, _ in named if n not in by_name]
    if missing:
        raise ValueError(f"checkpoint at step {step} missing leaves "
                         f"{missing[:5]}...")
    restored = iter([
        _load_leaf(os.path.join(d, by_name[name]["file"]),
                   by_name[name]["dtype"], leaf, dev,
                   None if shard_leaves is None else shard_leaves[i])
        for i, (name, leaf) in enumerate(named)])
    return _map_leaves(like, lambda _: next(restored)), step


def _load_leaf(path: str, logical: str, like: Any, dev: torch.device,
               sharding: Any = None) -> torch.Tensor:
    t = torch.from_numpy(np.load(path))
    want = like.dtype if isinstance(like, torch.Tensor) \
        else getattr(torch, logical)
    if sharding is None:
        return t.to(device=dev, dtype=want)
    from torch.distributed.tensor import distribute_tensor
    mesh, placements = sharding
    local = t.to(device=mesh.device_type, dtype=want)
    # every rank holds the whole leaf: no scatter from a source rank
    return distribute_tensor(local, mesh, placements, src_data_rank=None)


class Checkpointer:
    """Async checkpoint manager with retention; restores onto
    ``device`` (CUDA unless ``"cpu"``)."""

    def __init__(self, ckpt_dir: str, keep: int = 3, device: Any = None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.device = device
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves = 0

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        # copy to host synchronously (cheap vs. disk) so the train loop
        # can mutate its tensors immediately afterwards
        host_tree = _map_leaves(tree, _snapshot)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        self.saves += 1

    def save(self, step: int, tree: Any) -> str:
        self.wait()
        path = save_checkpoint(self.ckpt_dir, step, tree)
        self.saves += 1
        self._gc()
        return path

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None):
        self.wait()
        return restore_checkpoint(self.ckpt_dir, like, step, self.device,
                                  shardings)

    def latest(self) -> Optional[int]:
        return latest_step(self.ckpt_dir)

    def _gc(self) -> None:
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(int(m.group(1)) for d in os.listdir(self.ckpt_dir)
                       if (m := _STEP_RE.match(d)))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
