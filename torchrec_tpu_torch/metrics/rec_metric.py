"""RecMetric framework (``torchrec_tpu/metrics/rec_metric.py``): windowed,
multi-task metrics over additive states of torch tensors.

A metric is a triple of functions over a dict of tensors::

    init(n_tasks, device) -> state
    update(state, preds [T, B], labels [T, B], weights [T, B]) -> state
    compute(state) -> {name: [T]}

States are additive, so windowing is generic: a ring of the last ``W``
per-batch states (``[W, ...]`` tensors on the device) whose sum is the
window's state, beside a lifetime state accumulated with Kahan
compensation in float32, as the JAX package does.  The ring's slot and
fill counters are host ints, so an update never waits for the device;
``compute`` reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from torchrec_tpu_torch.metrics.metrics_namespace import (
    MetricPrefix,
    compose_metric_key,
)

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RecMetricComputation:
    """A metric as functions over its state.  ``windowed``: the
    framework keeps lifetime and window states (False for metrics over a
    window of raw examples, e.g. AUC).  ``name_namespaces`` maps an
    emitted value's name to its namespace when it is not
    ``namespace``."""

    namespace: str
    init: Callable[[int, torch.device], State]
    update: Callable[[State, torch.Tensor, torch.Tensor, torch.Tensor], State]
    compute: Callable[[State], Dict[str, torch.Tensor]]
    windowed: bool = True
    name_namespaces: Optional[Dict[str, str]] = None

    def namespace_for(self, name: str) -> str:
        if self.name_namespaces and name in self.name_namespaces:
            return self.name_namespaces[name]
        return self.namespace


@dataclasses.dataclass
class WindowedMetricState:
    """Lifetime state, its Kahan compensation, and the ring of per-batch
    states (each leaf ``[W, ...]``, zeros until written); ``slot`` is the
    next ring slot."""

    lifetime: State
    ring: State
    slot: int
    compensation: State


def init_windowed(comp: RecMetricComputation, n_tasks: int,
                  window_batches: int,
                  device: torch.device) -> WindowedMetricState:
    """Fresh lifetime and ring states for one computation."""
    zero = comp.init(n_tasks, device)
    return WindowedMetricState(
        lifetime=zero,
        ring={k: torch.zeros((window_batches,) + tuple(v.shape),
                             dtype=v.dtype, device=device)
              for k, v in zero.items()},
        slot=0, compensation=comp.init(n_tasks, device))


def update_windowed(comp: RecMetricComputation, st: WindowedMetricState,
                    preds: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor) -> WindowedMetricState:
    """Fold one batch into the lifetime sums (Kahan-compensated: the
    batch's state is the increment) and the ring."""
    batch = comp.update(comp.init(preds.shape[0], preds.device), preds,
                        labels, weights)
    y = {k: b - st.compensation[k] for k, b in batch.items()}
    lifetime = {k: s + y[k] for k, s in st.lifetime.items()}
    compensation = {k: (lifetime[k] - s) - y[k]
                    for k, s in st.lifetime.items()}
    W = next(iter(st.ring.values())).shape[0]
    for k, r in st.ring.items():
        r[st.slot % W] = batch[k]
    return WindowedMetricState(lifetime=lifetime, ring=st.ring,
                               slot=st.slot + 1, compensation=compensation)


def compute_windowed(comp: RecMetricComputation,
                     st: WindowedMetricState) -> Dict[str, Dict]:
    """``compute`` over the lifetime and the window states:
    ``{prefix: {name: [T]}}``."""
    window = {k: r.sum(dim=0) for k, r in st.ring.items()}
    return {MetricPrefix.LIFETIME.value: comp.compute(st.lifetime),
            MetricPrefix.WINDOW.value: comp.compute(window)}


@dataclasses.dataclass
class RecMetric:
    """One computation bound to a task list, with windowing."""

    comp: RecMetricComputation
    task_names: Tuple[str, ...]
    window_batches: int = 100

    def init(self, device: torch.device):
        if self.comp.windowed:
            return init_windowed(self.comp, len(self.task_names),
                                 self.window_batches, device)
        return self.comp.init(len(self.task_names), device)

    def update(self, state, preds, labels, weights):
        if self.comp.windowed:
            return update_windowed(self.comp, state, preds, labels, weights)
        return self.comp.update(state, preds, labels, weights)

    def compute(self, state) -> Dict[str, torch.Tensor]:
        """Flat ``{composed key: scalar tensor}``."""
        if self.comp.windowed:
            per_prefix = compute_windowed(self.comp, state)
        else:
            per_prefix = {MetricPrefix.LIFETIME.value:
                          self.comp.compute(state)}
        out: Dict[str, torch.Tensor] = {}
        for prefix, metrics in per_prefix.items():
            for name, vals in metrics.items():
                for t, task in enumerate(self.task_names):
                    out[compose_metric_key(self.comp.namespace_for(name),
                                           task, name, prefix)] = vals[t]
        return out
