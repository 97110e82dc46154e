"""The CPU-offloaded metric module (``torchrec_tpu/metrics/cpu_offloaded.py``;
reference ``metrics/cpu_offloaded_metric_module.py``): metric updates run
off the training thread, on the CPU, so the trainer never waits on
metric math and the card never spends a cycle on it.

The train thread stacks a batch's ``[T, B]`` predictions, labels and
weights where they are and queues non-blocking device -> host copies
into pinned buffers, with a CUDA event after them; it does not wait for
the card.  A worker thread waits on that event and folds the host tensors
into a CPU :class:`RecMetricModule`'s states.  The queue is bounded
(``queue_size``): a trainer more than that many batches ahead waits, as
the reference's update queue makes it.  An exception of the worker is
raised on the caller's next ``update``, ``flush`` or ``compute``.
``compute()`` flushes first, so results cover every update.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Mapping, Optional

import torch

from torchrec_tpu_torch.metrics.metric_module import (
    MetricsConfig,
    RecMetricModule,
)


class CpuOffloadedMetricModule:
    """A :class:`RecMetricModule` on the CPU whose ``update`` returns
    without waiting for the card or the metric math."""

    def __init__(self, config: MetricsConfig, batch_size: int,
                 queue_size: int = 8):
        self.inner = RecMetricModule(config, batch_size, device="cpu")
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._error: Optional[BaseException] = None
        self._worker: Optional[threading.Thread] = threading.Thread(
            target=self._drain, name="metrics-offload", daemon=True)
        self._worker.start()

    # -- the worker --------------------------------------------------------------

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            batch, ready = item
            try:
                if ready is not None:
                    ready.synchronize()
                with torch.no_grad():
                    for m, r in self.inner.metrics.items():
                        self.inner.states[m] = r.update(
                            self.inner.states[m], *batch)
            except BaseException as e:  # raised on the caller's next call
                self._error = e
            finally:
                self._q.task_done()

    # -- the trainer's side --------------------------------------------------------

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @torch.no_grad()
    def update(self, predictions: Mapping[str, torch.Tensor],
               labels: Mapping[str, torch.Tensor],
               weights: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        """Queue one batch's copy to the host; no wait on the card."""
        self._raise_pending()
        if self._worker is None:
            raise RuntimeError("CpuOffloadedMetricModule is closed")
        batch = self.inner.stack_batch(predictions, labels, weights)
        ready = None
        if batch[0].is_cuda:
            host = tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                         for x in batch)
            for h, x in zip(host, batch):
                h.copy_(x, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(batch[0].device))
            batch = host
        else:
            # the values at this call, whatever the caller does to its
            # tensors afterwards
            batch = tuple(x.clone() for x in batch)
        self._q.put((batch, ready))
        # throughput counts the batches' arrivals on the trainer's clock
        self.inner.throughput.update()

    def update_from_model_out(self,
                              model_out: Mapping[str, torch.Tensor]) -> None:
        self.update(*self.inner.extract_model_out(model_out))

    def flush(self) -> None:
        """Block until every queued batch is folded into the states."""
        self._q.join()
        self._raise_pending()

    def compute(self) -> Dict[str, float]:
        """Flush, then compute over every update so far."""
        self.flush()
        return self.inner.compute()

    def close(self) -> None:
        """Flush (raising a worker error) and stop the worker; ``compute``
        stays usable, ``update`` raises."""
        if self._worker is not None:
            try:
                self.flush()
            finally:
                self._q.put(None)
                self._worker.join(timeout=30)
                self._worker = None
