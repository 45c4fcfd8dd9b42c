# Online serving (counterpart of repro.serve): one config (ServeConfig),
# one factory (build_service), one process (PipelineService).  The
# reference's multi-process FleetService is not ported yet (ROADMAP
# Queue A item 4).  ScoringService still imports but is deprecated and
# intentionally absent from __all__, as in the reference.
from .config import ServeConfig, build_service, drive_closed_loop
from .registry import (SERVE_PIPELINES, ServeScenario, build_scenario,
                       run_closed_loop, warming_frame)
from .service import PipelineService, ServiceStats
from .service import ScoringService  # noqa: F401 - deprecated compat import

__all__ = ["ServeConfig", "build_service", "drive_closed_loop",
           "PipelineService", "ServiceStats",
           "ServeScenario", "SERVE_PIPELINES", "build_scenario",
           "run_closed_loop", "warming_frame"]
