# Online serving (counterpart of repro.serve): one config (ServeConfig),
# one factory (build_service), one process (PipelineService) or many
# (FleetService, spawned workers with one device each).  ScoringService
# still imports but is deprecated and intentionally absent from __all__,
# as in the reference.
from .config import ServeConfig, build_service, drive_closed_loop
from .fleet import FleetService, fleet_worker_main
from .registry import (SERVE_PIPELINES, ServeScenario, build_scenario,
                       run_closed_loop, warming_frame)
from .service import PipelineService, ServiceStats
from .service import ScoringService  # noqa: F401 - deprecated compat import

__all__ = ["ServeConfig", "build_service", "drive_closed_loop",
           "PipelineService", "FleetService", "fleet_worker_main",
           "ServiceStats",
           "ServeScenario", "SERVE_PIPELINES", "build_scenario",
           "run_closed_loop", "warming_frame"]
