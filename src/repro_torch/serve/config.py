"""ServeConfig — one declarative surface for every serving entry point.

Counterpart of ``repro.serve.config``.  ``repro_torch.cli serve``
(``cli/serve.py``), the launcher (``launch/serve.py``) and the
cache-warming job (``caching/warming.py``) describe the same thing — a
registry scenario, a cache location, micro-batching knobs — so
:class:`ServeConfig` names that description once and
:func:`build_service` turns it into a running
:class:`~repro_torch.serve.service.PipelineService`.

``device`` places the scenario's encoders and dense index (CUDA unless
``"cpu"``).  The reference's ``workers=N`` fleet of worker processes is
not ported yet: ``workers > 1`` raises ``NotImplementedError``.  The
config stays a plain picklable dataclass, as the reference's, so the
fleet can take it across a spawn boundary.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Union

__all__ = ["ServeConfig", "build_service", "drive_closed_loop"]

#: why ``workers > 1`` is refused: the multi-process fleet is the part of
#: serving the port has not taken yet
FLEET_NOT_PORTED = (
    "ServeConfig(workers > 1): the multi-process serving fleet "
    "(the reference's serve/fleet.py, spawned workers with one device "
    "each) is not ported to repro_torch yet (ROADMAP Queue A item 4); "
    "serve with workers=1")


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
    #: worker *processes*; 1 = in-process service (N>1, the reference's
    #: FleetService, is not ported: it raises).  The fleet's own knobs
    #: (``routing``, ``warm_start``, ``warm_budget``) come with it.
    workers: int = 1

    def __post_init__(self) -> None:
        from ..caching import select_backend
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.workers > 1:
            raise NotImplementedError(FLEET_NOT_PORTED)
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
    ``overrides`` are applied on top (``build_service(max_batch=8)``).
    Returns an in-process
    :class:`~repro_torch.serve.service.PipelineService`; ``workers > 1``
    (the reference's fleet) raises ``NotImplementedError``.

    ``pipeline`` (a transformer expression) or ``scenario`` (a built
    :class:`~repro_torch.serve.registry.ServeScenario`) short-circuit
    the registry lookup.
    """
    cfg = ServeConfig.coerce(config)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
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
    """Stand the configured service up, run the closed-loop generator,
    tear down, return a JSON-able stats record — the shared engine of
    ``repro_torch.cli serve`` and the launcher.  ``drain`` flushes
    the caches' write-behind queues before the summary (the reference
    also uses it to check a fleet's exit codes).  ``scenario``, a
    built :class:`~repro_torch.serve.registry.ServeScenario` of this
    config, skips rebuilding it, as in :func:`build_service`."""
    cfg = ServeConfig.coerce(config)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    from .registry import run_closed_loop
    if scenario is None:
        scenario = cfg.build_scenario()
    svc = build_service(cfg, scenario=scenario)
    explained = None
    try:
        loop = run_closed_loop(svc, scenario, n_requests=requests,
                               n_clients=clients, seed=cfg.seed)
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
    finally:
        svc.close()
    if explained is not None:
        record["_explain"] = explained
    return record
