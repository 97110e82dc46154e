"""RecMetricModule: per-step update, rare compute, and throughput
(a subset of ``torchrec_tpu/metrics/metric_module.py``).

The states live on the device of the predictions the module is built for
(``device``) and every update runs there with no host sync; ``compute``
reads them.  An update takes the batch the caller has: one rank's in a
multi-rank run (the JAX package's jitted update takes the global batch;
a caller that wants global metrics gathers first).  Throughput is a
host-side wall clock, as is :class:`TowerQPSMetric`'s (a tower's QPS after
its warm-up steps).  ``metrics/cpu_offloaded.py`` runs the updates on the
CPU on a worker thread.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from torchrec_tpu_torch.metrics.computations import (
    DEFAULT_COMPUTATIONS,
    make_auc,
)
from torchrec_tpu_torch.metrics.metrics_namespace import (
    MetricNamespace,
    MetricPrefix,
    compose_metric_key,
)
from torchrec_tpu_torch.metrics.rec_metric import RecMetric
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class RecTaskInfo:
    """One prediction task: ``name`` keys every metric output;
    ``label_name`` / ``prediction_name`` / ``weight_name`` select columns
    from a flat model-output dict (:meth:`RecMetricModule.extract_model_out`)."""

    name: str
    label_name: str = "label"
    prediction_name: str = "prediction"
    weight_name: str = "weight"


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """Which metrics to compute over which tasks."""

    tasks: Sequence[RecTaskInfo]
    metrics: Sequence[str] = (
        MetricNamespace.NE.value,
        MetricNamespace.CALIBRATION.value,
        MetricNamespace.CTR.value,
        MetricNamespace.AUC.value,
    )
    window_batches: int = 100
    auc_window_examples: int = 1 << 16


class ThroughputMetric:
    """Host-side examples/sec (reference throughput.py:35)."""

    def __init__(self, batch_size: int, window: int = 100):
        self.batch_size = batch_size
        self.window = window
        self.total_examples = 0
        self._t0: Optional[float] = None
        self._stamps: List[float] = []

    def update(self) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self.total_examples += self.batch_size
        self._stamps.append(now)
        if len(self._stamps) > self.window:
            self._stamps = self._stamps[-self.window:]

    def compute(self) -> Dict[str, float]:
        ns = MetricNamespace.THROUGHPUT.value

        def key(name, prefix):
            return compose_metric_key(ns, ns, name, prefix)

        out = {key("examples", MetricPrefix.TOTAL.value):
               float(self.total_examples)}
        if self._t0 is not None and self.total_examples > self.batch_size:
            elapsed = max(self._stamps[-1] - self._t0, 1e-9)
            out[key("qps", MetricPrefix.LIFETIME.value)] = (
                (self.total_examples - self.batch_size) / elapsed)
        if len(self._stamps) >= 2:
            dt = max(self._stamps[-1] - self._stamps[0], 1e-9)
            out[key("qps", MetricPrefix.WINDOW.value)] = (
                (len(self._stamps) - 1) * self.batch_size / dt)
        return out


class RecMetricModule:
    """The metric states of ``config.tasks`` x ``config.metrics`` on
    ``device`` (CUDA unless the caller names another); ``batch_size`` is
    the examples an update brings (throughput)."""

    def __init__(self, config: MetricsConfig, batch_size: int,
                 device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.task_names = tuple(t.name for t in config.tasks)
        self.tasks = tuple(config.tasks)
        self.metrics: Dict[str, RecMetric] = {}
        for m in config.metrics:
            if m == MetricNamespace.AUC.value:
                comp = make_auc(config.auc_window_examples)
            else:
                comp = DEFAULT_COMPUTATIONS[m]
            self.metrics[m] = RecMetric(comp, self.task_names,
                                        config.window_batches)
        self.states = {m: r.init(self.device)
                       for m, r in self.metrics.items()}
        self.throughput = ThroughputMetric(batch_size)

    def stack_batch(self, predictions: Mapping[str, torch.Tensor],
                    labels: Mapping[str, torch.Tensor],
                    weights: Optional[Mapping[str, torch.Tensor]] = None):
        """Per-task dicts of ``[B]`` tensors as the ``[T, B]`` float32
        tensors an update takes (weights default to 1)."""
        preds = torch.stack([predictions[t].to(torch.float32)
                             for t in self.task_names])
        labs = torch.stack([labels[t].to(torch.float32)
                            for t in self.task_names])
        if weights is None:
            w = torch.ones_like(preds)
        else:
            w = torch.stack([weights[t].to(torch.float32)
                             for t in self.task_names])
        return preds, labs, w

    def extract_model_out(self, model_out: Mapping[str, torch.Tensor]):
        """A flat model-output dict keyed by the tasks' label, prediction
        and weight names -> (preds, labels, weights) dicts."""
        preds = {t.name: model_out[t.prediction_name] for t in self.tasks}
        labels = {t.name: model_out[t.label_name] for t in self.tasks}
        weights = None
        if all(t.weight_name in model_out for t in self.tasks):
            weights = {t.name: model_out[t.weight_name] for t in self.tasks}
        return preds, labels, weights

    @torch.no_grad()
    def update(self, predictions: Mapping[str, torch.Tensor],
               labels: Mapping[str, torch.Tensor],
               weights: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        preds, labs, w = self.stack_batch(predictions, labels, weights)
        for m, r in self.metrics.items():
            self.states[m] = r.update(self.states[m], preds, labs, w)
        self.throughput.update()

    def update_from_model_out(self,
                              model_out: Mapping[str, torch.Tensor]) -> None:
        self.update(*self.extract_model_out(model_out))

    @torch.no_grad()
    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m, r in self.metrics.items():
            for k, v in r.compute(self.states[m]).items():
                out[k] = float(v)
        out.update(self.throughput.compute())
        return out


def generate_metric_module(config: MetricsConfig, batch_size: int,
                           device: DeviceLike = None) -> RecMetricModule:
    """Reference metric_module.py:719."""
    return RecMetricModule(config, batch_size, device=device)


class TowerQPSMetric:
    """Per-tower wall-clock QPS with a warm-up (reference tower_qps.py:46):
    the first ``warmup_steps`` batches are left out of the rate, so the
    first calls' build and warm-up time never lowers the steady QPS."""

    def __init__(self, batch_size: int, warmup_steps: int = 10,
                 window: int = 100):
        self.batch_size = batch_size
        self.warmup_steps = warmup_steps
        self.window = window
        self.steps = 0
        self.total_examples = 0
        self.warmup_examples = 0
        self._t_start: Optional[float] = None
        self._stamps: List[Tuple[float, int]] = []

    def update(self, num_examples: Optional[int] = None) -> None:
        n = self.batch_size if num_examples is None else num_examples
        self.steps += 1
        self.total_examples += n
        now = time.perf_counter()
        if self.steps <= self.warmup_steps:
            self.warmup_examples += n
            if self.steps == self.warmup_steps:
                self._t_start = now
            return
        if self._t_start is None:
            # warmup_steps == 0: the first batch starts the clock, and its
            # examples count as warm-up (no interval holds their work)
            self.warmup_examples += n
            self._t_start = now
        self._stamps.append((now, n))
        if len(self._stamps) > self.window:
            self._stamps = self._stamps[-self.window:]

    def compute(self) -> Dict[str, float]:
        ns = MetricNamespace.TOWER_QPS.value

        def key(name, prefix):
            return compose_metric_key(ns, ns, name, prefix)

        out = {key("examples", MetricPrefix.TOTAL.value):
               float(self.total_examples)}
        post = self.total_examples - self.warmup_examples
        if self._t_start is not None and self._stamps and post > 0:
            elapsed = max(self._stamps[-1][0] - self._t_start, 1e-9)
            out[key("qps", MetricPrefix.LIFETIME.value)] = post / elapsed
        if len(self._stamps) >= 2:
            dt = max(self._stamps[-1][0] - self._stamps[0][0], 1e-9)
            # the examples landed after the window's first stamp
            n_window = sum(n for _, n in self._stamps[1:])
            out[key("qps", MetricPrefix.WINDOW.value)] = n_window / dt
        return out
