"""Observability (``torchrec_tpu/obs``), the JAX package's 18 names:

* :mod:`.spans`: nested, thread-aware spans around every pipeline stage,
  each a profiler range, recorded by an installed :class:`SpanTracer`
  and exported as EventLog JSONL and Chrome trace-event JSON;
* :mod:`.registry`: the :class:`MetricsRegistry` (counters, gauges,
  fixed-bucket histograms) that absorbs every ``scalar_metrics()``
  surface under ``<prefix>/<table>/<counter>`` and serves Prometheus text
  and JSONL dumps;
* :mod:`.device_poll`: the :class:`DeviceMetricsPump`, step metrics read
  from the card on a background thread through a bounded queue;
* :mod:`.assumptions`, :mod:`.health`, :mod:`.flight_recorder`: the
  planner's stamped assumptions, the drift monitor that holds a run to
  them, and the crash flight recorder.

``python -m torchrec_tpu_torch.obs report`` (:mod:`.report`) turns a
run's artifacts into per-stage p50 / p99, overlap ratios, wire bytes,
health state (``--health``) and placement-features rows.
"""

from torchrec_tpu_torch.obs.assumptions import (
    ASSUMPTIONS_SCHEMA_VERSION,
    PlanAssumptions,
    TableAssumptions,
)
from torchrec_tpu_torch.obs.device_poll import DeviceMetricsPump
from torchrec_tpu_torch.obs.flight_recorder import (
    FlightRecorder,
    current_recorder,
    install_recorder,
    uninstall_recorder,
)
from torchrec_tpu_torch.obs.health import (
    DriftAlert,
    DriftDetector,
    HealthMonitor,
)
from torchrec_tpu_torch.obs.registry import (
    DEFAULT_LATENCY_BUCKETS_MS,
    MetricsRegistry,
)
from torchrec_tpu_torch.obs.spans import (
    SpanTracer,
    current_tracer,
    install_tracer,
    span,
    uninstall_tracer,
)

__all__ = [
    "ASSUMPTIONS_SCHEMA_VERSION",
    "DEFAULT_LATENCY_BUCKETS_MS",
    "DeviceMetricsPump",
    "DriftAlert",
    "DriftDetector",
    "FlightRecorder",
    "HealthMonitor",
    "MetricsRegistry",
    "PlanAssumptions",
    "SpanTracer",
    "TableAssumptions",
    "current_recorder",
    "current_tracer",
    "install_recorder",
    "install_tracer",
    "span",
    "uninstall_recorder",
    "uninstall_tracer",
]
