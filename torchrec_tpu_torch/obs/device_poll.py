"""The device-metrics path off the step's thread
(``torchrec_tpu/obs/device_poll.py``).

A step's metrics stay on the card until something reads them; a
``float(metrics["loss"])`` after every step waits for the card and
serializes the pipeline.  :class:`DeviceMetricsPump` moves that read to a
daemon thread: ``submit()`` puts the step's metrics (a dict / list tree
of tensors and numbers) into a bounded queue and returns; the worker
lands them in a :class:`~torchrec_tpu_torch.obs.registry.MetricsRegistry`
(each leaf a gauge, its value when it has one element, else its sum;
configured leaves also observed into a histogram).

What lands is the value at ``submit``: a torch step may update a metric
tensor in place afterwards, or free it for the caching allocator to reuse.
So ``submit`` copies each tensor leaf on the card (on the current stream,
no sync: ``clone`` is queued like any kernel) and records a CUDA event
after the copies; the worker waits on that event, then reads the copies
to the host.  The caller's thread never waits for the card.

Backpressure: a full queue drops the submission and counts it
(``obs/pump/dropped_count``), it never blocks a step.  A leaf that cannot
be read is counted (``obs/pump/fetch_error_count``); the caller reads
that count and decides (``chip_smoke.py`` fails on any).  ``flush()``
waits until every accepted submission landed; ``close()`` flushes and
stops the worker.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.obs.registry import MetricsRegistry
from torchrec_tpu_torch.obs.spans import span

__all__ = ["DeviceMetricsPump"]


def _flatten(prefix: str, obj: Any, out: Dict[str, Any]) -> None:
    """dict / list tree -> flat ``{"<prefix>/<k0>/<k1>": leaf}``."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}/{k}", v, out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(f"{prefix}/{i}", v, out)
    else:
        out[prefix] = obj


def _host_array(leaf: Any) -> np.ndarray:
    """A leaf as a host array (a tensor copied back; 16-bit floats
    numpy has no type for widened to float32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


class DeviceMetricsPump:
    """Background device -> host metrics fetcher over a bounded queue.

    registry: where the values land (a fresh one by default).
    prefix: the step metrics' namespace (``<prefix>/<leaf>`` gauges).
    capacity: the queue's bound; a full queue drops and counts.
    histograms: leaf names (under ``prefix``) also observed into
        ``<prefix>/<leaf>/hist`` histograms: p50 / p99 over steps.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        prefix: str = "step",
        capacity: int = 16,
        histograms: Iterable[str] = (),
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._prefix = prefix
        self._hist = {f"{prefix}/{h}" for h in histograms}
        # (step, flat leaves, the events after their copies); None stops
        self._q: "queue.Queue[Optional[Tuple]]" = queue.Queue(
            maxsize=max(1, capacity))
        self.dropped = 0
        self._closed = False
        self._thread = threading.Thread(target=self._worker,
                                        name="obs-metrics-pump", daemon=True)
        self._thread.start()

    # -- the step's thread ----------------------------------------------------

    def submit(self, metrics: Any, step: Optional[int] = None) -> bool:
        """Queue a step's metrics without waiting for the card; False
        (and the drop counted) when the queue is full or the pump is
        closed."""
        if self._closed:
            return False
        if self._q.full():
            return self._drop()
        flat: Dict[str, Any] = {}
        _flatten(self._prefix, metrics, flat)
        events: List[torch.cuda.Event] = []
        devices = set()
        for name, leaf in flat.items():
            if isinstance(leaf, torch.Tensor):
                flat[name] = leaf.detach().clone()
                if leaf.is_cuda:
                    devices.add(leaf.device)
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        try:
            self._q.put_nowait((step, flat, events))
            return True
        except queue.Full:
            return self._drop()

    def _drop(self) -> bool:
        self.dropped += 1
        self.registry.counter("obs/pump/dropped_count")
        return False

    # -- the worker -------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._land(*item)
            except Exception:
                self.registry.counter("obs/pump/fetch_error_count")
            finally:
                self._q.task_done()

    def _land(self, step: Optional[int], flat: Dict[str, Any],
              events: List[torch.cuda.Event]) -> None:
        reg = self.registry
        with span("obs/device_fetch"):
            for ev in events:
                ev.synchronize()  # the copies are done: waits here only
            for name, leaf in flat.items():
                try:
                    arr = _host_array(leaf)
                except Exception:
                    reg.counter("obs/pump/fetch_error_count")
                    continue
                if arr.dtype.kind not in "fiub":
                    continue
                v = (float(arr.reshape(-1)[0]) if arr.size == 1
                     else float(arr.sum()))
                reg.gauge(name, v)
                if name in self._hist:
                    reg.observe(f"{name}/hist", v)
        if step is not None:
            reg.gauge("obs/pump/last_step", float(step))

    # -- lifecycle ----------------------------------------------------------------

    def flush(self) -> None:
        """Block until every accepted submission has landed."""
        self._q.join()

    def close(self) -> None:
        """Flush, then stop the worker (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._q.join()
        self._q.put(None)
        self._thread.join(timeout=5)
