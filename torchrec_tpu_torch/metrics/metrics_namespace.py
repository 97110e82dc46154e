"""Metric key naming (reference ``metrics/metrics_namespace.py``).

Keys compose as ``{metric_namespace}-{task_name}|{prefix}_{name}``, e.g.
``ne-ctr_task|window_ne`` — kept string-compatible with the reference so
dashboards can be ported unchanged.
"""

from __future__ import annotations

import enum


class MetricNamespace(str, enum.Enum):
    """Metric family names (reference metrics_namespace.py) — used as
    the first segment of every composed metric key."""
    NE = "ne"
    LOG_LOSS = "logloss"
    CALI_FREE_NE = "cali_free_ne"
    NE_POSITIVE = "ne_positive"
    NMSE = "nmse"
    NRMSE = "nrmse"
    HINDSIGHT_TARGET_PR = "hindsight_target_pr"
    CTR = "ctr"
    CALIBRATION = "calibration"
    AUC = "auc"
    AUPRC = "auprc"
    MSE = "mse"
    MAE = "mae"
    RMSE = "rmse"
    ACCURACY = "accuracy"
    PRECISION = "precision"
    RECALL = "recall"
    F1 = "f1"
    NDCG = "ndcg"
    GAUC = "gauc"
    MULTICLASS_RECALL = "multiclass_recall"
    WEIGHTED_AVG = "weighted_avg"
    SCALAR = "scalar"
    THROUGHPUT = "throughput"
    RAUC = "rauc"
    PRECISION_SESSION = "precision_session"
    RECALL_SESSION = "recall_session"
    TOWER_QPS = "tower_qps"


class MetricPrefix(str, enum.Enum):
    """Aggregation window qualifier in composed keys (reference
    MetricPrefix): lifetime / window / total."""
    LIFETIME = "lifetime"
    WINDOW = "window"
    TOTAL = "total"


def compose_metric_key(
    namespace: str, task_name: str, name: str, prefix: str
) -> str:
    """Reference key format: ``namespace-task|prefix_name``."""
    return f"{namespace}-{task_name}|{prefix}_{name}"
