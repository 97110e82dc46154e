"""Observability (``torchrec_tpu/obs``): the metrics registry
(``registry``), spans on the profiler's timeline (``spans``), the flight
recorder (``flight_recorder``), the planner's stamped assumptions
(``assumptions``) and the drift monitor that holds a run to them
(``health``)."""

from torchrec_tpu_torch.obs.assumptions import (
    PlanAssumptions,
    TableAssumptions,
)
from torchrec_tpu_torch.obs.health import (
    DriftAlert,
    DriftDetector,
    HealthMonitor,
)
from torchrec_tpu_torch.obs.registry import MetricsRegistry

__all__ = [
    "DriftAlert",
    "DriftDetector",
    "HealthMonitor",
    "MetricsRegistry",
    "PlanAssumptions",
    "TableAssumptions",
]
