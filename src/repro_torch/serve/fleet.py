"""Multi-process serve fleet: N PipelineService workers, one cache.

Counterpart of ``repro.serve.fleet``.  ``FleetService`` scales the
serving layer past one process while keeping the single-process API:
``submit(qid, query, **extra)`` returns a future exactly like
:class:`~repro_torch.serve.service.PipelineService`, so the closed-loop
generator and the CLI drive either interchangeably (``build_service``
picks by ``workers=``).

Topology
--------
The front-end **demux** (this process) owns the client-facing futures
and a duplex ``multiprocessing.Pipe`` per worker.  Each **worker
process** rebuilds the scenario from the shared
:class:`~repro_torch.serve.config.ServeConfig`, compiles its own
``PipelineService`` over the *same* cache directory, optionally replays
the expected traffic through the plan (``warm_start`` — all hits over a
warmed directory, so a respawned worker rejoins warm), then serves
requests from its pipe.  Routing follows ``config.routing``: ``"rr"``
(default) round-robins requests over the live workers, ``"qid"`` hashes
the qid stably so repeat traffic for a query reaches the same worker's
micro-batcher; either way the per-qid frames resolve the original
futures, and deterministic pipelines make the answers
routing-independent.

Where it departs from the reference
-----------------------------------
* **Spawn only.**  CUDA does not survive ``fork``; workers are spawned
  and the config crosses the boundary pickled.
* **One device per worker.**  With ``config.device`` ``None`` or
  ``"cuda"``, worker ``w`` serves on ``cuda:{w % device_count}`` (it
  calls ``torch.cuda.set_device`` before building anything); with
  ``"cpu"`` it never initialises CUDA.  Without a card and without
  ``"cpu"`` a worker raises (``resolve_device``): nothing falls back.
* **Host data only across the pipe.**  Result frames and stats hold
  numpy and Python values; a worker checks each reply before sending,
  since a CUDA tensor cannot cross a ``Pipe`` without CUDA IPC.
* **One reaper per worker.**  Exactly one thread (``fleet-reaper-<w>``)
  waits on each worker process and publishes its exit code through an
  event; ``drain`` and ``close`` wait on that event and never ``join``
  the process themselves.  Two threads in ``Popen.wait`` race on
  ``os.waitpid``: the loser gets ``ECHILD`` and reads an exit code of
  ``None`` until the winner has stored it.
* **Ready workers first.**  Requests go to the live workers that are
  ready while there are any, so a respawned worker's start (seconds on
  the card) does not hold the requests routed to it.
* **The drain report** gives each worker's device and the launches of
  the ``dense_topk`` and ``cachekey_hash`` kernels in that process, at
  start (after the plan's compile and the warm replay) and at drain —
  the only record the parent has that the workers ran the kernels.

Fault handling
--------------
A worker death is seen as EOF on its pipe.  The demux then (a)
requeues every accepted request that was in flight on the dead worker
onto survivors — accepted requests are never lost, they are recomputed
elsewhere; (b) respawns a replacement, paced by
:class:`~repro_torch.distrib.fault.RetryPolicy` backoff, which warms
itself from the manifests before taking traffic.  Per-request requeues
are bounded by the same policy; exhausting it fails that request's
future with the underlying error.  A worker that dies before it is
ready is not respawned (a replacement would fail the same way), and at
start-up it fails the fleet's construction with its exit code; the
reference respawns it until its budget is spent.

``drain()`` is the graceful shutdown: each worker finishes its
in-flight work, closes its service — which refreshes the cache
manifests (entry counts, access stats) on disk — reports its stats and
exits 0.  ``repro_torch.cli serve --drain`` reports the exit codes.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import zlib
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from ..distrib.fault import RetryPolicy
from .config import ServeConfig
from .service import ServiceStats

__all__ = ["FleetService", "fleet_worker_main"]


def _qid_slot(qid: str, n: int) -> int:
    """Stable (cross-process, cross-run) qid → worker slot hash."""
    return zlib.crc32(str(qid).encode("utf-8")) % max(1, n)


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

def _worker_device(device: Any, worker_id: int) -> str:
    """The device worker ``worker_id`` serves on, made current: one card
    a worker, round robin over the cards, unless ``device`` names
    one (or the CPU)."""
    import torch

    from ..device import resolve_device
    if device is None or str(device) == "cuda":
        resolve_device(device)           # raises without a card
        dev = torch.device("cuda", worker_id % torch.cuda.device_count())
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return str(dev)


def _kernel_launches() -> Dict[str, int]:
    """The launch counters of the serving path's kernel wrappers in this
    process."""
    from ..kernels.cachekey_hash import cachekey_hash
    from ..kernels.dense_topk import dense_topk
    return {"dense_topk": int(dense_topk.launches),
            "cachekey_hash": int(cachekey_hash.launches)}


def _host_only(obj: Any, where: str = "reply") -> None:
    """Raise unless ``obj`` holds only host values (numpy arrays, Python
    scalars, strings and containers of them, ColFrames of such
    columns): nothing a ``Pipe`` would need CUDA IPC for."""
    import numpy as np
    import torch

    from ..core.frame import ColFrame
    if isinstance(obj, torch.Tensor):
        raise TypeError(f"fleet worker: a tensor on {obj.device} in the "
                        f"{where}; only host values cross the pipe")
    if isinstance(obj, ColFrame):
        for name in obj.columns:
            _host_only(obj[name], f"{where} column {name!r}")
    elif isinstance(obj, np.ndarray):
        if obj.dtype == object:
            for x in obj.ravel().tolist():
                _host_only(x, where)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _host_only(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for x in obj:
            _host_only(x, where)


def fleet_worker_main(conn, cfg: ServeConfig, worker_id: int) -> None:
    """Entry point of one worker process (module-level: spawn pickles
    it by reference).  Protocol, parent → worker::

        ("req", rid, row)   serve one row; reply ("res", rid, frame)
                            or ("err", rid, repr)
        ("drain",)          finish in-flight work, close the service
                            (refreshing manifests), reply
                            ("drained", wid, stats), exit 0
        ("stop",)           close immediately, exit 0

    and worker → parent additionally ``("ready", wid, info)`` once the
    local service is built (and warmed): the warm counts as the
    reference reports them, plus ``device``, ``start_s`` (seconds of
    each start step, and ``entered_at``, the wall clock on entry, from
    which the parent derives the spawn and import time) and
    ``kernel_launches_at_start``."""
    entered_at = time.time()
    t = time.perf_counter()
    from ..caching.provenance import set_digest_device
    from .config import build_service
    from .registry import warming_frame

    device = _worker_device(cfg.device, worker_id)
    set_digest_device("cpu" if device == "cpu" else "cuda")
    cfg = dataclasses.replace(cfg.single(), device=device)
    start_s: Dict[str, float] = {"entered_at": entered_at,
                                 "device": time.perf_counter() - t}
    t = time.perf_counter()
    scenario = cfg.build_scenario()
    start_s["scenario"] = time.perf_counter() - t
    t = time.perf_counter()
    svc = build_service(cfg, scenario=scenario)
    start_s["service"] = time.perf_counter() - t
    info: Dict[str, Any] = {}
    if cfg.warm_start and cfg.cache_dir:
        t0 = time.perf_counter()
        frame = warming_frame(scenario, budget=cfg.warm_budget,
                              seed=cfg.seed)
        stats = svc.plan.warm(frame)
        info = {"queries_warmed": int(len(frame)),
                "warm_hits": int(stats.cache_hits),
                "warm_misses": int(stats.cache_misses),
                "warm_wall_s": round(time.perf_counter() - t0, 4)}
    start_s["warm"] = info.get("warm_wall_s", 0.0)
    warm_info = dict(info)
    at_start = _kernel_launches()
    info.update(device=device, start_s=start_s,
                kernel_launches_at_start=at_start)
    send_lock = threading.Lock()
    outstanding = [0]
    done_cv = threading.Condition()
    conn.send(("ready", worker_id, info))

    def _reply(payload) -> None:
        try:
            with send_lock:
                conn.send(payload)
        except (BrokenPipeError, OSError):
            pass                         # parent gone; nothing to tell

    def _on_done(fut: Future, rid: int) -> None:
        try:
            frame = fut.result()
            _host_only(frame)
            _reply(("res", rid, frame))
        except BaseException as e:       # noqa: BLE001 - relay verbatim
            _reply(("err", rid, repr(e)))
        with done_cv:
            outstanding[0] -= 1
            done_cv.notify_all()

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):      # parent died: nothing to serve
            svc.close()
            return
        kind = msg[0]
        if kind == "req":
            rid, row = msg[1], dict(msg[2])
            qid = row.pop("qid")
            query = row.pop("query")
            with done_cv:
                outstanding[0] += 1
            try:
                fut = svc.submit(qid, query, **row)
            except BaseException as e:   # noqa: BLE001 - relay verbatim
                with done_cv:
                    outstanding[0] -= 1
                    done_cv.notify_all()
                _reply(("err", rid, repr(e)))
                continue
            fut.add_done_callback(lambda f, rid=rid: _on_done(f, rid))
        elif kind == "drain":
            svc.flush()
            with done_cv:
                done_cv.wait_for(lambda: outstanding[0] == 0, timeout=60.0)
            stats = {"worker": worker_id,
                     **svc.stats.summary(),
                     "online": svc.online_stats.as_dict(svc.max_batch),
                     "cache_prefetched":
                         int(svc.plan_stats().cache_prefetched),
                     **warm_info}
            svc.close()                  # refreshes manifests on disk
            stats.update(device=device, start_s=start_s,
                         kernel_launches_at_start=at_start,
                         kernel_launches=_kernel_launches())
            _host_only(stats, "drain stats")
            _reply(("drained", worker_id, stats))
            conn.close()
            return                       # process exit code 0
        elif kind == "stop":
            svc.close()
            conn.close()
            return


# ---------------------------------------------------------------------------
# demux (parent) side
# ---------------------------------------------------------------------------

class _Worker:
    """Parent-side handle of one worker process."""

    __slots__ = ("id", "proc", "conn", "send_lock", "ready", "drained",
                 "eof", "exited", "alive", "drain_stats", "warm_info",
                 "exit_code", "spawn_s", "started_at")

    def __init__(self, wid: int, proc, conn):
        self.id = wid
        self.proc = proc
        self.conn = conn
        self.send_lock = threading.Lock()
        self.ready = threading.Event()
        self.drained = threading.Event()
        #: set once the reader has seen the pipe close (every message
        #: the worker sent has been handled)
        self.eof = threading.Event()
        #: set by the worker's reaper once ``exit_code`` is known
        self.exited = threading.Event()
        self.alive = True
        self.drain_stats: Optional[Dict[str, Any]] = None
        self.warm_info: Dict[str, Any] = {}
        self.exit_code: Optional[int] = None
        self.spawn_s = 0.0
        self.started_at = 0.0

    def send(self, payload) -> None:
        with self.send_lock:
            self.conn.send(payload)


class FleetService:
    """Demux over N spawned ``PipelineService`` worker processes.

    Implements the service surface the closed-loop generator relies on
    (``submit`` → future, ``stats``, ``flush``, ``close``) plus the
    fleet lifecycle: ``drain()`` for graceful shutdown with refreshed
    manifests, ``kill_worker()`` as the chaos hook of the fault tests.
    """

    def __init__(self, config: Any = None, *,
                 retry: Optional[RetryPolicy] = None,
                 start_timeout: float = 300.0,
                 reservoir_capacity: int = 4096,
                 **overrides: Any):
        self.config = ServeConfig.coerce(config)
        if overrides:
            self.config = dataclasses.replace(self.config, **overrides)
        self.retry = retry or RetryPolicy(max_retries=3, base_delay_s=0.05)
        self.stats = ServiceStats(reservoir_capacity)
        self._lock = threading.RLock()
        self._rids = itertools.count()
        self._wids = itertools.count()
        self._rr = itertools.count()
        #: rid -> {"row", "future", "worker", "attempts", "t0"}
        self._inflight: Dict[int, Dict[str, Any]] = {}
        self._workers: Dict[int, _Worker] = {}
        #: every worker ever spawned, dead ones included
        self._all: List[_Worker] = []
        self.respawns = 0
        self.requeued = 0
        self._max_respawns = self.config.workers * (self.retry.max_retries + 1)
        self._draining = False
        #: respawns decided but not spawned yet; ``drain`` waits for them
        self._respawning = 0
        self._respawned = threading.Condition(self._lock)
        self._closed = False
        self._drain_report: Optional[Dict[str, Any]] = None
        import multiprocessing as mp
        self._ctx = mp.get_context("spawn")
        try:
            for _ in range(self.config.workers):
                self._spawn()
            self._wait_ready(start_timeout)
        except BaseException:
            self.close(drain=False)
            raise

    # -- worker lifecycle ----------------------------------------------------
    def _spawn(self) -> "_Worker":
        wid = next(self._wids)
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=fleet_worker_main,
            args=(child_conn, self.config, wid),
            name=f"fleet-worker-{wid}", daemon=True)
        t = time.perf_counter()
        proc.start()
        w = _Worker(wid, proc, parent_conn)
        w.spawn_s = time.perf_counter() - t
        w.started_at = time.time()
        child_conn.close()               # parent keeps its end only
        with self._lock:
            self._workers[wid] = w
            self._all.append(w)
        threading.Thread(target=self._reap, args=(w,),
                         name=f"fleet-reaper-{wid}", daemon=True).start()
        threading.Thread(target=self._reader, args=(w,),
                         name=f"fleet-reader-{wid}", daemon=True).start()
        return w

    def _reap(self, w: _Worker) -> None:
        """The one thread that waits on ``w``'s process: records its exit
        code, then sets ``w.exited``."""
        from multiprocessing.connection import wait
        wait([w.proc.sentinel])          # returns once the process ended
        w.proc.join()
        code = w.proc.exitcode
        deadline = time.monotonic() + 5.0
        while code is None and time.monotonic() < deadline:
            # ``Process.start`` polls every child of this process
            # (``multiprocessing.process._cleanup``); if that poll
            # reaped the worker first, it is storing the code now
            time.sleep(0.005)
            code = w.proc.exitcode
        w.exit_code = code
        w.exited.set()

    def _wait_ready(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                failed = [w for w in self._all
                          if not w.alive and not w.ready.is_set()]
                pending = [w for w in self._workers.values()
                           if w.alive and not w.ready.is_set()]
            if failed:
                w = failed[0]
                w.exited.wait(5.0)
                raise RuntimeError(
                    f"fleet startup failed: worker {w.id} exited with code "
                    f"{w.exit_code} before it was ready (its traceback is "
                    f"on stderr)")
            if not pending:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet startup timed out after {timeout}s waiting for "
                    f"workers {[w.id for w in pending]}")
            pending[0].ready.wait(0.2)

    def _reader(self, w: _Worker) -> None:
        while True:
            try:
                msg = w.conn.recv()
            except (EOFError, OSError):
                break
            kind = msg[0]
            if kind == "ready":
                info = dict(msg[2])
                start = dict(info.get("start_s", {}))
                entered = start.pop("entered_at", None)
                start["spawn"] = w.spawn_s
                if entered is not None:
                    start["imports"] = max(0.0, entered - w.started_at)
                info["start_s"] = start
                w.warm_info = info
                w.ready.set()
            elif kind == "res":
                self._resolve(msg[1], msg[2], None)
            elif kind == "err":
                self._resolve(msg[1], None, RuntimeError(msg[2]))
            elif kind == "drained":
                stats = dict(msg[2])
                stats["start_s"] = dict(w.warm_info.get("start_s", {}))
                w.drain_stats = stats
                w.drained.set()
        self._on_worker_exit(w)

    def _on_worker_exit(self, w: _Worker) -> None:
        with self._lock:
            w.alive = False
            self._workers.pop(w.id, None)
            orphaned = [rid for rid, e in self._inflight.items()
                        if e["worker"] == w.id]
        w.eof.set()
        if self._draining or self._closed or w.drained.is_set():
            return
        # unexpected death: respawn warm (bounded) — unless the worker
        # never came up, which a replacement would repeat — and requeue
        # the orphaned accepted requests onto survivors
        with self._lock:
            may_respawn = w.ready.is_set() and \
                self.respawns < self._max_respawns
            if may_respawn:
                self.respawns += 1
                attempt = self.respawns
                self._respawning += 1
        if may_respawn:
            try:
                time.sleep(self.retry.delay(attempt))
                if not self._closed:     # a drain waits for this spawn
                    self._spawn()
            finally:
                with self._lock:
                    self._respawning -= 1
                    self._respawned.notify_all()
        for rid in orphaned:
            self.requeued += 1
            self._dispatch(rid)

    # -- request path --------------------------------------------------------
    def submit(self, qid: Any, query: str, **extra: Any) -> Future:
        """Asynchronously serve one query through the fleet; resolves
        to the per-qid result frame, exactly like
        ``PipelineService.submit``.  Once accepted (this method
        returned), the request survives worker deaths — it is requeued
        to a surviving worker and recomputed there."""
        if self._closed or self._draining:
            raise RuntimeError("FleetService is closed")
        row = {"qid": str(qid), "query": query, **extra}
        fut: Future = Future()
        rid = next(self._rids)
        with self._lock:
            self._inflight[rid] = {"row": row, "future": fut,
                                   "worker": None, "attempts": 0,
                                   "t0": time.perf_counter()}
        self._dispatch(rid)
        return fut

    def _dispatch(self, rid: int) -> None:
        while True:
            with self._lock:
                entry = self._inflight.get(rid)
                if entry is None:        # already resolved (late requeue)
                    return
                entry["attempts"] += 1
                if entry["attempts"] > self.retry.max_retries + 1:
                    self._inflight.pop(rid, None)
                    entry["future"].set_exception(RuntimeError(
                        f"request {entry['row'].get('qid')!r} failed after "
                        f"{entry['attempts'] - 1} dispatch attempts "
                        f"(workers kept dying)"))
                    return
                live = [w for w in self._workers.values() if w.alive]
                # a respawned worker takes traffic once it is ready
                live = [w for w in live if w.ready.is_set()] or live
                if not live:
                    self._inflight.pop(rid, None)
                    entry["future"].set_exception(RuntimeError(
                        "no live fleet workers to dispatch to"))
                    return
                if self.config.routing == "qid":
                    slot = _qid_slot(entry["row"]["qid"], len(live))
                else:
                    slot = next(self._rr) % len(live)
                w = live[slot]
                entry["worker"] = w.id
            try:
                w.send(("req", rid, entry["row"]))
                return
            except (BrokenPipeError, OSError):
                # raced a death the reader has not processed yet; the
                # loop re-picks among the remaining workers
                with self._lock:
                    w.alive = False

    def _resolve(self, rid: int, frame, error) -> None:
        with self._lock:
            entry = self._inflight.pop(rid, None)
        if entry is None:                # duplicate/late reply
            return
        dt_ms = (time.perf_counter() - entry["t0"]) * 1000.0
        self.stats.record_batch(n_requests=1, latencies_ms=[dt_ms])
        if error is not None:
            entry["future"].set_exception(error)
        else:
            entry["future"].set_result(frame)

    def flush(self) -> None:
        """No-op at the demux: each worker's streaming executor flushes
        on its own ``max_batch``/``max_wait_ms`` window."""

    # -- introspection -------------------------------------------------------
    @property
    def worker_ids(self) -> List[int]:
        with self._lock:
            return sorted(w.id for w in self._workers.values() if w.alive)

    @property
    def warm_info(self) -> Dict[int, Dict[str, Any]]:
        """Per live worker: its warm counts (as the reference's), device,
        start seconds and kernel launches at start."""
        with self._lock:
            return {w.id: dict(w.warm_info)
                    for w in self._workers.values()}

    def kill_worker(self, worker_id: Optional[int] = None) -> int:
        """Chaos hook: SIGKILL one live worker (the lowest id by
        default) and return its id.  The demux requeues its in-flight
        requests and respawns a warm replacement."""
        with self._lock:
            live = sorted((w.id, w) for w in self._workers.values()
                          if w.alive)
            if not live:
                raise RuntimeError("no live workers to kill")
            wid, w = live[0] if worker_id is None else \
                (worker_id, self._workers[worker_id])
        w.proc.kill()
        return wid

    # -- lifecycle -----------------------------------------------------------
    def _await_exit(self, w: _Worker, deadline: float) -> None:
        """Wait for ``w``'s reaper; past the deadline, SIGTERM the
        process and give the reaper 5 s more."""
        if not w.exited.wait(max(0.1, deadline - time.monotonic())):
            w.proc.terminate()           # refuse to hang: escalate
            w.exited.wait(5.0)

    def drain(self, timeout: float = 120.0) -> Dict[str, Any]:
        """Graceful shutdown: every worker finishes in-flight work,
        closes its service — refreshing the cache manifests on disk —
        reports stats and exits 0.  Returns the fleet report
        (per-worker stats, exit codes of the drained workers and of those
        lost before, respawn/requeue counters, aggregated cache totals);
        idempotent."""
        if self._drain_report is not None:
            return self._drain_report
        deadline = time.monotonic() + timeout
        with self._lock:
            self._draining = True
            # a replacement being spawned is drained with the rest
            self._respawned.wait_for(lambda: self._respawning == 0,
                                     max(0.0, deadline - time.monotonic()))
            workers = [w for w in self._workers.values() if w.alive]
        for w in workers:
            try:
                w.send(("drain",))
            except (BrokenPipeError, OSError):
                pass
        for w in workers:
            w.eof.wait(max(0.0, deadline - time.monotonic()))
            self._await_exit(w, deadline)
        with self._lock:
            lost = [w for w in self._all if w not in workers]
        for w in lost:
            w.exited.wait(max(0.1, deadline - time.monotonic()))
        per_worker = [w.drain_stats for w in workers
                      if w.drain_stats is not None]
        hits = sum(int(s["online"]["cache_hits"]) for s in per_worker)
        misses = sum(int(s["online"]["cache_misses"]) for s in per_worker)
        self.stats.add_cache_counts(hits, misses)
        batches = sum(int(s.get("batches", 0)) for s in per_worker)
        occ = (sum(float(s["online"]["batch_occupancy"])
                   * int(s.get("batches", 0)) for s in per_worker)
               / batches) if batches else 0.0
        self._drain_report = {
            "workers": [dict(s) for s in per_worker],
            "exit_codes": {w.id: w.exit_code for w in workers},
            "lost_exit_codes": {w.id: w.exit_code for w in lost},
            "respawns": self.respawns,
            "requeued": self.requeued,
            "online": {"cache_hits": hits, "cache_misses": misses,
                       "batches": batches,
                       "batch_occupancy": round(occ, 4)},
        }
        return self._drain_report

    def close(self, drain: bool = True) -> None:
        if self._closed:
            return
        if drain and not self._draining:
            try:
                self.drain()
            except Exception:
                pass
        self._closed = True
        with self._lock:
            workers = list(self._all)
            pending = list(self._inflight.values())
            self._inflight.clear()
        for e in pending:
            if not e["future"].done():
                e["future"].set_exception(
                    RuntimeError("FleetService closed"))
        for w in workers:
            if not w.exited.is_set():
                try:
                    w.send(("stop",))
                except (BrokenPipeError, OSError):
                    pass
        deadline = time.monotonic() + 5.0
        for w in workers:
            self._await_exit(w, deadline)
            try:
                w.conn.close()
            except OSError:
                pass

    def __enter__(self) -> "FleetService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
