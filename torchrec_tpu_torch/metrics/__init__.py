from torchrec_tpu_torch.metrics.metric_module import (
    MetricsConfig,
    RecMetricModule,
    RecTaskInfo,
    ThroughputMetric,
    TowerQPSMetric,
    generate_metric_module,
)
from torchrec_tpu_torch.metrics.metrics_namespace import (
    MetricNamespace,
    MetricPrefix,
    compose_metric_key,
)
from torchrec_tpu_torch.metrics.rec_metric import (
    RecMetric,
    RecMetricComputation,
)

__all__ = [
    "MetricsConfig",
    "RecMetricModule",
    "RecTaskInfo",
    "ThroughputMetric",
    "TowerQPSMetric",
    "generate_metric_module",
    "MetricNamespace",
    "MetricPrefix",
    "compose_metric_key",
    "RecMetric",
    "RecMetricComputation",
]
