"""ServeConfig — one declarative surface for every serving entry point.

Counterpart of ``repro.serve.config``.  ``repro_torch.cli serve``
(``cli/serve.py``), the launcher (``launch/serve.py``) and the
cache-warming job (``caching/warming.py``) describe the same thing — a
registry scenario, a cache location, micro-batching knobs — so
:class:`ServeConfig` names that description once and
:func:`build_service` turns it into a running service:

* ``workers=1`` (default) → an in-process
  :class:`~repro_torch.serve.service.PipelineService`;
* ``workers=N`` → a :class:`~repro_torch.serve.fleet.FleetService` of N
  spawned worker processes over the same cache directory.

``device`` places the scenario's encoders and dense index (CUDA unless
``"cpu"``); a fleet gives each worker one device (``serve/fleet.py``).
Fleet workers consume the *same* config (``single()``, ``workers``
forced to 1) to build their local service, which is what keeps a fleet
per-qid equal to a single process.  The config is a plain picklable
dataclass, so it crosses the spawn boundary unchanged.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Union

__all__ = ["ServeConfig", "build_service", "drive_closed_loop"]

@dataclass
class ServeConfig:
    """Everything needed to stand up (and warm) a serving scenario.

    Scenario identity — ``pipeline``/``scale``/``cutoff``/
    ``num_results``/``seed`` — must match between warming and serving
    (and does by construction when both read one config): node
    fingerprints, and hence cache directories, derive from it.
    """

    # -- scenario identity ---------------------------------------------------
    pipeline: str = "bm25-mono"
    scale: float = 0.05
    cutoff: int = 10
    num_results: int = 100
    seed: int = 0
    #: where the encoders and the dense index live: ``None`` is CUDA,
    #: ``"cpu"`` the CPU (``repro_torch.device.resolve_device``)
    device: Optional[str] = None

    # -- cache plumbing ------------------------------------------------------
    cache_dir: Optional[str] = None
    #: a ``caching.select_backend`` selector (``"sqlite"``,
    #: ``"tiered:dbm"``, ``"mmap:sqlite"``, …); ``None`` keeps each
    #: cache family's default
    backend: Optional[str] = None
    on_stale: str = "error"
    optimize: Union[str, Sequence[str], None] = "all"
    #: asynchronous cache data plane (``caching/dataplane.py``): issue
    #: warm-path store reads on a background I/O pool as soon as a
    #: batch's frame exists and buffer miss-path writes behind.  Results
    #: are per-qid bit-identical either way — ``False`` is the ablation
    #: knob
    prefetch: bool = True

    # -- micro-batching / executor knobs ------------------------------------
    #: positive int, or ``"auto"`` to take the compiled plan's autotuned
    #: value (derived from the manifest's measured occupancy history)
    max_batch: Union[int, str] = 16
    #: milliseconds, or ``"auto"`` (see ``max_batch``)
    max_wait_ms: Union[float, str] = 2.0
    #: thread-pool size of each service's streaming executor
    exec_workers: int = 4
    queue_capacity: int = 1024

    # -- fleet topology ------------------------------------------------------
    #: worker *processes*; 1 = in-process service, N>1 = FleetService
    workers: int = 1
    #: demux routing policy: ``"rr"`` round-robins requests over live
    #: workers (load-balanced — a zipf-hot qid does not bottleneck one
    #: worker); ``"qid"`` hashes the qid so repeat traffic for a query
    #: always lands on the same worker's micro-batcher.  Results are
    #: reassembled per qid either way, and deterministic pipelines
    #: make the answers routing-independent.
    routing: str = "rr"
    #: fleet workers replay the scenario's expected traffic through
    #: their plan on start (all hits over a warmed dir), so a respawned
    #: worker rejoins warm; ignored without a ``cache_dir``
    warm_start: bool = True
    #: cap the warm replay to the N most-expected queries
    warm_budget: Optional[int] = None

    def __post_init__(self) -> None:
        from ..caching import select_backend
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.routing not in ("rr", "qid"):
            raise ValueError(f"routing must be 'rr' or 'qid', "
                             f"got {self.routing!r}")
        for knob in ("max_batch", "max_wait_ms"):
            v = getattr(self, knob)
            if isinstance(v, str) and v != "auto":
                raise ValueError(f"{knob} must be a number or 'auto', "
                                 f"got {v!r}")
        if not isinstance(self.max_batch, str) and int(self.max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, "
                             f"got {self.max_batch}")
        if self.backend is not None:
            # validate eagerly (and keep the normalized form) so a bad
            # selector fails at config time, not inside a worker process
            self.backend = select_backend(self.backend)

    # -- derived -------------------------------------------------------------
    def build_scenario(self):
        """The registry scenario this config names, on ``device`` —
        deterministic, so every build reconstructs the identical
        pipeline."""
        from .registry import build_scenario
        return build_scenario(self.pipeline, scale=self.scale,
                              cutoff=self.cutoff,
                              num_results=self.num_results, seed=self.seed,
                              device=self.device)

    def service_kwargs(self) -> Dict[str, Any]:
        """Constructor kwargs for a single
        :class:`~repro_torch.serve.service.PipelineService`."""
        return dict(cache_dir=self.cache_dir, cache_backend=self.backend,
                    on_stale=self.on_stale, optimize=self.optimize,
                    max_batch=self.max_batch, max_wait_ms=self.max_wait_ms,
                    max_workers=self.exec_workers,
                    queue_capacity=self.queue_capacity,
                    prefetch=self.prefetch)

    def single(self) -> "ServeConfig":
        """This config as one worker process sees it (``workers=1``)."""
        return dataclasses.replace(self, workers=1)

    @classmethod
    def coerce(cls, obj: Any) -> "ServeConfig":
        """Accept a ``ServeConfig``, a kwargs dict, or ``None``."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls(**obj)
        raise TypeError(f"cannot build a ServeConfig from "
                        f"{type(obj).__name__}: {obj!r}")


def build_service(config: Any = None, *, scenario: Any = None,
                  pipeline: Any = None, **overrides: Any):
    """The one serving factory: a running service from a config.

    ``config`` is anything :meth:`ServeConfig.coerce` accepts;
    ``overrides`` are applied on top (``build_service(workers=4)``).
    With ``workers == 1`` returns an in-process
    :class:`~repro_torch.serve.service.PipelineService`; with
    ``workers > 1`` a :class:`~repro_torch.serve.fleet.FleetService`
    over spawned worker processes.

    ``pipeline`` (a transformer expression) or ``scenario`` (a built
    :class:`~repro_torch.serve.registry.ServeScenario`) short-circuit
    the registry lookup for the in-process case; the fleet always
    rebuilds the scenario from the config's name inside each worker —
    pipeline objects (and the tensors they hold) do not cross the
    process boundary.
    """
    cfg = ServeConfig.coerce(config)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.workers > 1:
        if pipeline is not None or scenario is not None:
            raise ValueError(
                "a fleet rebuilds its scenario from the config's registry "
                "name inside each worker process; pass pipeline=/scenario= "
                "only with workers=1")
        from .fleet import FleetService
        return FleetService(cfg)
    from .service import PipelineService
    if pipeline is None:
        if scenario is None:
            scenario = cfg.build_scenario()
        pipeline = scenario.pipeline
    return PipelineService(pipeline, **cfg.service_kwargs())


def drive_closed_loop(config: Any = None, *, requests: int = 200,
                      clients: int = 4, explain: bool = False,
                      drain: bool = False, scenario: Any = None,
                      **overrides: Any) -> Dict[str, Any]:
    """Stand the configured service (or fleet) up, run the closed-loop
    generator, tear down, return a JSON-able stats record — the shared
    engine of ``repro_torch.cli serve`` and the launcher.  A fleet is
    always drained (its workers' cache totals fold into the record, the
    drain report lands in ``record["fleet"]``), and ``drain`` adds
    ``record["drained"]``: whether every worker exited 0.  In one
    process ``drain`` flushes the caches' write-behind queues before
    the summary.  ``scenario``, a built
    :class:`~repro_torch.serve.registry.ServeScenario` of this config,
    skips rebuilding it here (each fleet worker builds its own)."""
    cfg = ServeConfig.coerce(config)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    from .registry import run_closed_loop
    if scenario is None:
        scenario = cfg.build_scenario()
    svc = build_service(cfg, scenario=scenario if cfg.workers == 1 else None)
    explained = None
    fleet_report = None
    try:
        loop = run_closed_loop(svc, scenario, n_requests=requests,
                               n_clients=clients, seed=cfg.seed)
        if cfg.workers > 1:
            # graceful drain folds the workers' cache totals into
            # svc.stats before the summary is taken
            fleet_report = svc.drain()
            online = fleet_report["online"]
        else:
            if drain:
                svc.drain()
            online = svc.online_stats.as_dict(svc.max_batch)
            if explain:
                explained = svc.explain()
        summary = svc.stats.summary()
        record = {
            "pipeline": cfg.pipeline,
            "description": scenario.description,
            "optimize": cfg.optimize,
            # the resolved values ("auto" resolves at service build)
            "max_batch": getattr(svc, "max_batch", cfg.max_batch),
            "max_wait_ms": getattr(svc, "max_wait_ms", cfg.max_wait_ms),
            "workers": cfg.workers,
            **loop, **summary,
            "online": online,
        }
        if fleet_report is not None:
            record["fleet"] = fleet_report
    finally:
        svc.close()
    if explained is not None:
        record["_explain"] = explained
    if drain and fleet_report is not None:
        record["drained"] = all(c == 0
                                for c in fleet_report["exit_codes"].values())
    return record
