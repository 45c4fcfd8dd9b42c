"""CompileCache — "precomputation of compilation", as CUDA graphs.

Counterpart of ``repro.caching.compile_cache``.  The reference memoises
XLA executables so that two pipelines sharing a scorer at one shape pay
compilation once.  PyTorch runs eagerly and compiles nothing; what an
eager encoder pays per call on the card is its launches (dozens of small
kernels a bucket).  So the port memoises one ``torch.cuda.CUDAGraph``
per (name, abstract input signature, device, weight source):

* **on a CUDA device** a miss warms the function up once and captures
  it on a side stream of its own (``capture_error_mode="thread_local"``,
  so other threads keep launching meanwhile), at static input buffers of
  the call's shapes, into a memory pool of its own (graphs that share a
  pool cannot replay concurrently).  Every call, the miss's first one
  included, copies its inputs into the static buffers, replays the graph
  and clones the outputs, under the entry's lock: the next replay
  overwrites the static outputs.  A capture that fails raises;
* **on the CPU** there is nothing to capture: a miss records the entry
  and every call runs the entry's function eagerly.  Hits and misses
  count by the same rules.

A graph replays raw pointers, so an entry holds a strong reference to
the function it captured, and through it to the weights the function
closes over: a dropped scorer's weights stay alive for its graphs, and
freed memory is never read by a replay.

Deliberate differences from the reference:

* the key holds the **weight source** (``weight_source=``; the scorers
  pass their config and ``Encoder.weight_source``).  The reference keys
  by (name, signature, mesh, jit kwargs) only, so two scorers of one
  config name with other weights share an executable that closes over
  the first one's weights;
* there is **no disk layer**: PyTorch cannot persist a CUDA graph, so
  ``CompileCache`` takes no ``path`` (passing one raises ``TypeError``)
  and ``CompileCacheStats.disk_hits`` stays 0.  The reference's disk
  layer is best-effort too;
* no ``jit_kwargs``, and the function runs under
  ``torch.inference_mode()``: the memo serves forward passes.

``compile_time_s`` counts the warm-up and the capture.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core import trace

__all__ = ["CompileCache", "CompileCacheStats", "signature_of_args",
           "default_compile_cache"]


def _flatten(tree: Any, leaves: List[Any]) -> str:
    """Appends ``tree``'s leaves to ``leaves`` (dict keys sorted, as
    ``jax.tree`` orders them) and returns its structure as a string."""
    if isinstance(tree, (tuple, list)):
        inner = ",".join(_flatten(t, leaves) for t in tree)
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, dict):
        return "dict(" + ",".join(f"{k!r}:{_flatten(tree[k], leaves)}"
                                  for k in sorted(tree)) + ")"
    leaves.append(tree)
    return "*"


def _map(tree: Any, fn: Callable[[Any], Any]) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _abstractify(x: Any) -> Tuple:
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return ("arr", tuple(x.shape), str(x.dtype))
    return ("lit", repr(x))


def signature_of_args(args, kwargs) -> Tuple:
    """(abstract leaves, structure) of a call's arguments: shapes and
    dtypes of its arrays, reprs of everything else."""
    leaves: List[Any] = []
    structure = _flatten((tuple(args), dict(kwargs)), leaves)
    return (tuple(_abstractify(leaf) for leaf in leaves), structure)


@dataclass
class CompileCacheStats:
    compile_hits: int = 0
    compile_misses: int = 0
    disk_hits: int = 0          # always 0: a CUDA graph is not persisted
    compile_time_s: float = 0.0

    def __str__(self):
        return (f"compiles={self.compile_misses} reuses={self.compile_hits} "
                f"disk_hits={self.disk_hits} "
                f"compile_time={self.compile_time_s:.2f}s")


def _device_of(args, kwargs) -> torch.device:
    leaves: List[Any] = []
    _flatten((tuple(args), dict(kwargs)), leaves)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class _Eager:
    """A CPU entry: the function, called as it is."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.calls = 0

    def run(self, args, kwargs):
        with torch.inference_mode():
            return self.fn(*args, **kwargs)


class _Graph:
    """A CUDA entry: the function captured once at static inputs."""

    def __init__(self, fn: Callable, args, kwargs, device: torch.device):
        self.fn = fn     # strong: the weights it closes over outlive us
        self.calls = 0
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()   # the last replay's copy-out
        with torch.inference_mode():
            self.static = _map((tuple(args), dict(kwargs)), lambda x: x.clone()
                               if isinstance(x, torch.Tensor) else x)
            s_args, s_kwargs = self.static
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                fn(*s_args, **s_kwargs)        # lazy init (cuBLAS) first
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.out = fn(*s_args, **s_kwargs)
                finally:
                    self.graph.capture_end()
            stream.synchronize()
        inputs: List[Any] = []
        _flatten(self.static, inputs)
        self.inputs = [x for x in inputs if isinstance(x, torch.Tensor)]

    def run(self, args, kwargs):
        leaves: List[Any] = []
        _flatten((tuple(args), dict(kwargs)), leaves)
        new = [x for x in leaves if isinstance(x, torch.Tensor)]
        stream = torch.cuda.current_stream(self.inputs[0].device
                                           if self.inputs else None)
        with self.lock, torch.inference_mode():
            # a replay enqueued on another stream must be done with the
            # static buffers before this call's copy-in overwrites them
            stream.wait_event(self.done)
            for dst, src in zip(self.inputs, new):
                dst.copy_(src)
            self.graph.replay()
            out = _map(self.out, lambda t: t.clone()
                       if isinstance(t, torch.Tensor) else t)
            self.done.record(stream)
        return out


class CompileCache:
    """Process-wide memo of CUDA graphs (eager entries on the CPU)."""

    #: one capture at a time in a process; replays of other entries go on
    _capture_lock = threading.Lock()

    def __init__(self, *args, **kwargs):
        if args or kwargs:
            raise TypeError(
                "repro_torch's CompileCache takes no arguments: a CUDA graph "
                "cannot be persisted, so there is no disk layer (path=)")
        self._mem: Dict[Tuple, Any] = {}
        self._lock = threading.Lock()
        self.stats = CompileCacheStats()

    def entries(self) -> List[Tuple[Tuple, int]]:
        """(key, calls) of every entry: a CUDA entry's calls are its graph
        replays, the capturing call's included."""
        with self._lock:
            return [(k, e.calls) for k, e in self._mem.items()]

    def _hit(self, key: Tuple):
        with self._lock:
            entry = self._mem.get(key)
            if entry is not None:
                self.stats.compile_hits += 1
            return entry

    def get_compiled(self, name: str, fn: Callable, *args,
                     weight_source: Optional[Any] = None, **kwargs):
        """The entry of ``fn`` at these (abstract) args on their device
        with these weights, captured on a miss."""
        device = _device_of(args, kwargs)
        key = (name, signature_of_args(args, kwargs), str(device),
               weight_source)
        entry = self._hit(key)
        if entry is not None:
            return entry
        with self._capture_lock:
            entry = self._hit(key)
            if entry is not None:
                return entry
            t0 = time.perf_counter()
            with trace.span("compile_cache.capture", entry=name):
                entry = _Graph(fn, args, kwargs, device) \
                    if device.type == "cuda" else _Eager(fn)
            with self._lock:
                self._mem[key] = entry
                self.stats.compile_misses += 1
                self.stats.compile_time_s += time.perf_counter() - t0
        return entry

    def call(self, name: str, fn: Callable, *args,
             weight_source: Optional[Any] = None, **kwargs):
        """``fn(*args, **kwargs)`` through the memo: a graph replay on a
        CUDA device, the entry's function on the CPU.  Outputs are fresh
        tensors."""
        entry = self.get_compiled(name, fn, *args,
                                  weight_source=weight_source, **kwargs)
        with self._lock:
            entry.calls += 1
        return entry.run(args, kwargs)


#: module-level default instance (shared across pipeline stages)
default_compile_cache = CompileCache()
