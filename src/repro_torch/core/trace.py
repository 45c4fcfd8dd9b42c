"""The port's one span and counter recorder.

``span(name, **attrs)`` is a context manager around a piece of work and
``count(name, n)`` adds to a counter.  Both go to the process recorder,
which is **off by default**: then ``span`` hands back one shared no-op
object and ``count`` returns at once (no clock read, no lock, nothing
kept).  Nothing in the port turns it on; an operator or a benchmark
calls ``enable()`` around the work it wants to see and ``disable()``
to take back the :class:`Recorder` that holds what was recorded.

A span keeps its name, an id, its parent's id (from a per-thread stack
of open spans), the request id where one exists (given, or inherited
from the parent), the thread's native id and its pthread id, start and
end from ``time.perf_counter_ns()`` and a few attributes.  The store is
bounded: past ``capacity`` spans are dropped and counted.

Spans that start on one thread and end on another (a served request's
wait in the queue, a task's wait for a pool worker) are recorded whole
with :func:`add` from explicit clock reads.

**One clock with the device trace.**  At ``enable()`` and ``disable()``
the recorder pairs ``perf_counter_ns()`` with ``time.time_ns()`` (the
tightest of five back-to-back reads).  ``torch.profiler``'s Chrome
export writes ``ts`` as wall-clock microseconds less the trace's
``baseTimeNanoseconds`` (checked on torch 2.11 with CUDA and 2.13 on
the CPU), so :meth:`Recorder.to_trace_us` maps a span there,
interpolating between the two pairs; :meth:`Recorder.drift_ns` is how
far the clocks moved apart over the recording, and
:meth:`Recorder.chrome_events` gives the spans as ``"X"`` events on the
threads' native ids, to merge into a profiler export.

The plan executors keep a private :class:`Recorder` per ``run`` /
``warm`` for ``PlanStats`` (``plan.node`` spans); a node span also goes
to the process recorder when that is on (:func:`node_span`).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

__all__ = ["span", "count", "add", "node_span", "add_node", "enable",
           "disable", "active", "now_ns", "Recorder", "SpanRecord",
           "ClockPair", "NOOP"]

#: how many spans ``enable()`` keeps unless told otherwise
DEFAULT_CAPACITY = 1_000_000


class ClockPair(NamedTuple):
    """``perf_counter_ns()`` and ``time.time_ns()`` read together;
    ``width_ns`` is how long the read took (its uncertainty)."""
    perf_ns: int
    wall_ns: int
    width_ns: int


def read_clock_pair(tries: int = 5) -> ClockPair:
    """The tightest of ``tries`` back-to-back reads of both clocks."""
    best: Optional[ClockPair] = None
    for _ in range(tries):
        p0 = time.perf_counter_ns()
        w = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best.width_ns:
            best = ClockPair((p0 + p1) // 2, w, p1 - p0)
    return best


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int                 # 0: no parent on this thread
    req: Any                    # a request id, a tuple of them, or None
    #: the ids a device trace may give the thread's launches: its
    #: native id, or for a thread that existed before the profiler
    #: started its pthread id's low 32 bits (unsigned, signed, or
    #: ``2**32 - pthread`` as torch 2.11 on the H100 writes it)
    tid: int                    # threading.get_native_id()
    pthread: int                # threading.get_ident() & 0xFFFFFFFF
    t0: int                     # perf_counter_ns
    t1: int
    attrs: Optional[Dict[str, Any]]

    @property
    def requests(self) -> Tuple:
        if self.req is None:
            return ()
        return self.req if isinstance(self.req, tuple) else (self.req,)


class _Noop:
    """What ``span()`` returns while no recorder is on: one object."""
    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _Noop()


class _Open:
    """A span being recorded: opened on ``__enter__``, kept on
    ``__exit__``, on the thread that entered it."""
    __slots__ = ("rec", "name", "req", "attrs", "id", "parent", "t0")

    def __init__(self, rec: "Recorder", name: str, req: Any,
                 attrs: Optional[Dict[str, Any]]):
        self.rec = rec
        self.name = name
        self.req = req
        self.attrs = attrs

    def __enter__(self) -> "_Open":
        stack = self.rec._stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.req is None:
                self.req = top.req
        else:
            self.parent = 0
        self.id = next(self.rec._ids)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        stack = self.rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self.rec._keep(SpanRecord(
            self.name, self.id, self.parent, self.req,
            threading.get_native_id(), threading.get_ident() & 0xFFFFFFFF,
            self.t0, t1, self.attrs))
        return False


class Recorder:
    """Spans and counters, safe across threads.

    ``capacity=None`` keeps every span (a plan run's private record);
    the process recorder is bounded by ``enable(capacity=...)``."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, float] = {}
        self.dropped = 0
        self.start = read_clock_pair()
        self.stop: Optional[ClockPair] = None
        self._closed = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    # -- recording -----------------------------------------------------------
    def _stack(self) -> List[_Open]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _keep(self, rec: SpanRecord) -> None:
        with self._lock:
            if self._closed or (self.capacity is not None
                                and len(self.spans) >= self.capacity):
                self.dropped += 1
            else:
                self.spans.append(rec)

    def span(self, name: str, req: Any = None, **attrs: Any) -> _Open:
        return _Open(self, name, req, attrs or None)

    def add(self, name: str, t0_ns: int, t1_ns: int, req: Any = None,
            **attrs: Any) -> None:
        """Keep a span measured elsewhere (``t0_ns``/``t1_ns`` from
        ``perf_counter_ns``), on this thread, under its open span."""
        stack = self._stack()
        parent = stack[-1].id if stack else 0
        if req is None and stack:
            req = stack[-1].req
        self._keep(SpanRecord(
            name, next(self._ids), parent, req, threading.get_native_id(),
            threading.get_ident() & 0xFFFFFFFF, int(t0_ns), int(t1_ns),
            attrs or None))

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def close(self) -> "Recorder":
        """Stop taking spans (later ones are dropped and counted) and
        read the stop clock pair."""
        with self._lock:
            self._closed = True
        self.stop = read_clock_pair()
        return self

    # -- reading -------------------------------------------------------------
    @property
    def records(self) -> List[Tuple[str, int, float, float]]:
        """(node label, shard, t0, t1) in seconds of every ``plan.node``
        span: what ``PlanStats`` is filled from."""
        with self._lock:
            spans = list(self.spans)
        return [(s.attrs["node"], s.attrs["shard"], s.t0 * 1e-9, s.t1 * 1e-9)
                for s in spans if s.name == "plan.node"]

    def named(self, name: str) -> List[SpanRecord]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def _offset_ns(self, t_ns: int) -> float:
        """wall − perf at ``t_ns``, interpolated between the start and
        stop pairs."""
        a, b = self.start, self.stop
        off0 = a.wall_ns - a.perf_ns
        if b is None or b.perf_ns == a.perf_ns:
            return float(off0)
        off1 = b.wall_ns - b.perf_ns
        return off0 + (off1 - off0) * (t_ns - a.perf_ns) / (b.perf_ns
                                                            - a.perf_ns)

    def drift_ns(self) -> Optional[int]:
        """How far wall − perf moved between the start and stop pairs."""
        if self.stop is None:
            return None
        return ((self.stop.wall_ns - self.stop.perf_ns)
                - (self.start.wall_ns - self.start.perf_ns))

    def to_trace_us(self, t_ns: int, base_ns: int) -> float:
        """``perf_counter_ns`` time -> the profiler export's ``ts``: wall
        microseconds less the trace's ``baseTimeNanoseconds``."""
        return (t_ns + self._offset_ns(t_ns) - base_ns) / 1e3

    def chrome_events(self, base_ns: int) -> List[Dict[str, Any]]:
        """The spans as Chrome-trace complete (``"X"``) events on the
        profiler's clock and the threads' native ids; ``args`` holds the
        span and parent ids, the request ids, the pthread id and the
        attributes."""
        pid = os.getpid()
        with self._lock:
            spans = list(self.spans)
        out = []
        for s in spans:
            ts = self.to_trace_us(s.t0, base_ns)
            args: Dict[str, Any] = {"id": s.id, "parent": s.parent,
                                    "pthread": s.pthread}
            if s.req is not None:
                args["req"] = list(s.requests)
            if s.attrs:
                args.update(s.attrs)
            out.append({"ph": "X", "cat": "repro_torch", "name": s.name,
                        "pid": pid, "tid": s.tid, "ts": ts,
                        "dur": self.to_trace_us(s.t1, base_ns) - ts,
                        "args": args})
        return out


# -- the process recorder ---------------------------------------------------
_active: Optional[Recorder] = None
_switch = threading.Lock()


def active() -> Optional[Recorder]:
    """The process recorder, or None while recording is off."""
    return _active


def enable(capacity: int = DEFAULT_CAPACITY) -> Recorder:
    """Turn recording on with a fresh recorder holding at most
    ``capacity`` spans."""
    global _active
    with _switch:
        if _active is not None:
            raise RuntimeError("the span recorder is already on")
        _active = Recorder(int(capacity))
        return _active


def disable() -> Optional[Recorder]:
    """Turn recording off; returns what was recorded (None if it was
    off).  Spans still open then are dropped and counted."""
    global _active
    with _switch:
        rec, _active = _active, None
    return rec.close() if rec is not None else None


def span(name: str, **attrs: Any):
    """A span on the process recorder (``req=`` names the request), or
    the shared no-op while recording is off."""
    rec = _active
    if rec is None:
        return NOOP
    return rec.span(name, **attrs)


def count(name: str, n: float = 1) -> None:
    rec = _active
    if rec is not None:
        rec.count(name, n)


def add(name: str, t0_ns: int, t1_ns: int, **attrs: Any) -> None:
    """Keep a span measured with :func:`now_ns` elsewhere."""
    rec = _active
    if rec is not None:
        rec.add(name, t0_ns, t1_ns, **attrs)


def now_ns() -> int:
    """``perf_counter_ns()`` while recording is on, else 0: the start
    of a span that another thread ends (:func:`add`)."""
    return time.perf_counter_ns() if _active is not None else 0


class _NodeSpan:
    """A plan node's execution on a plan run's recorder and, while it
    is on, the process recorder."""
    __slots__ = ("spans",)

    def __init__(self, spans: List[_Open]):
        self.spans = spans

    def __enter__(self) -> "_NodeSpan":
        for s in self.spans:
            s.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        for s in reversed(self.spans):
            s.__exit__(*exc)
        return False


def node_span(run: Optional[Recorder], label: str, shard: int,
              req: Any = None):
    """The ``plan.node`` span of one node execution: kept on ``run``
    (a plan run's recorder, or None) and on the process recorder."""
    spans = [r.span("plan.node", req, node=label, shard=shard)
             for r in (run, _active) if r is not None]
    if not spans:
        return NOOP
    return spans[0] if len(spans) == 1 else _NodeSpan(spans)


def add_node(run: Optional[Recorder], label: str, shard: int, t0_ns: int,
             t1_ns: int, req: Any = None) -> None:
    """A ``plan.node`` span measured elsewhere, kept as
    :func:`node_span` keeps one."""
    for r in (run, _active):
        if r is not None:
            r.add("plan.node", t0_ns, t1_ns, req, node=label, shard=shard)
