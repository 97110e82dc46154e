"""Inference server: dynamic batching + the serving module on its device
(``PyBatchingQueue`` and ``InferenceServer`` of
``torchrec_tpu/inference/serving.py``).

``predict`` enqueues single requests; the batching queue forms them into
batches (flush at ``max_batch`` requests or ``max_latency_us`` after the
oldest pending one); executor threads pad each formed batch to the
serving function's static shapes, move it to the serving function's
device, run it, and post per-request scores back.  The queue is the
pure-Python one; the native queue and the network front ends are not
ported yet.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.obs.registry import MetricsRegistry
from torchrec_tpu_torch.obs.spans import span
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, regroup_request_major
from torchrec_tpu_torch.utils.profiling import counter_key

# dynamic-batch sizes are small powers-of-two-ish; the default latency
# ladder would lump everything into one bucket
_BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class QueueStopped(RuntimeError):
    """The batching queue was shut down while (or before) this request
    was in it: the replica is stopping, not slow."""


class PyBatchingQueue:
    """Pure-Python dynamic batching queue.

    Producers ``enqueue`` single requests and block in ``wait_result``;
    the executor ``dequeue_batch``-es formed batches and ``post_result``-s
    per-request scores.  Results abandoned by a timed-out client are
    purged after ``_RESULT_TTL_S`` so the result map stays bounded.

    ``max_batch`` / ``max_latency_us`` are the forming policy (flush on
    size or deadline); ``num_dense`` and ``num_features`` fix each
    request's dense width and per-feature lengths width."""

    _RESULT_TTL_S = 60.0

    def __init__(
        self,
        max_batch: int,
        max_latency_us: int,
        num_dense: int,
        num_features: int,
    ):
        self.max_batch = int(max_batch)
        self.max_latency_s = max_latency_us * 1e-6
        self.num_dense = int(num_dense)
        self.num_features = int(num_features)
        # two conditions over ONE lock: a posted result wakes only result
        # waiters, not every blocked producer and executor
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._cv_results = threading.Condition(self._mu)
        self._pending: collections.deque = collections.deque()
        self._results: dict = {}
        self._next_id = 1
        self._oldest: Optional[float] = None
        self._shutdown = False
        # requests enqueued whose score has not yet been posted (pending +
        # inside an executor): what a graceful drain waits on
        self._inflight = 0

    def enqueue(
        self, dense: np.ndarray, ids: np.ndarray, lengths: np.ndarray
    ) -> int:
        """Add one request; returns its id for ``wait_result``.  Raises
        :class:`QueueStopped` after ``shutdown()``."""
        dense = np.ascontiguousarray(dense, np.float32).reshape(-1)
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        lengths = np.ascontiguousarray(lengths, np.int32).reshape(-1)
        if dense.shape != (self.num_dense,):
            raise ValueError(f"dense {dense.shape} != ({self.num_dense},)")
        if lengths.shape != (self.num_features,):
            raise ValueError(
                f"lengths {lengths.shape} != ({self.num_features},)"
            )
        with self._cv:
            if self._shutdown:
                raise QueueStopped(
                    "batching queue is shut down; request refused"
                )
            rid = self._next_id
            self._next_id += 1
            self._inflight += 1
            self._pending.append((rid, dense.copy(), ids.copy(),
                                  lengths.copy()))
            if len(self._pending) == 1:
                self._oldest = time.monotonic()
            self._cv.notify_all()
            return rid

    def dequeue_batch(self, timeout_us: int) -> Tuple[
        int, np.ndarray, np.ndarray, np.ndarray, np.ndarray
    ]:
        """Block for a formed batch.  Returns ``(n, rids, dense, ids,
        lengths)`` with ``n`` -1 on shutdown, 0 on timeout, else the batch
        size (``dense`` [n, D], ``ids`` flat request-major, ``lengths``
        [n, F])."""
        deadline = time.monotonic() + timeout_us * 1e-6
        with self._cv:
            while True:
                if self._shutdown:
                    return -1, *self._empty()
                now = time.monotonic()
                if self._pending:
                    full = len(self._pending) >= self.max_batch
                    stale = now - self._oldest >= self.max_latency_s
                    if full or stale:
                        break
                wait_until = deadline
                if self._pending:
                    wait_until = min(
                        wait_until, self._oldest + self.max_latency_s
                    )
                remaining = wait_until - now
                if remaining <= 0 or not self._cv.wait(remaining):
                    if time.monotonic() >= deadline:
                        if not self._pending:
                            return 0, *self._empty()
                        break  # deadline with pending work: flush it
            n = min(len(self._pending), self.max_batch)
            reqs = [self._pending.popleft() for _ in range(n)]
            if self._pending:
                # the flush clock restarts for the leftover requests
                self._oldest = time.monotonic()
        rids = np.asarray([r[0] for r in reqs], np.uint64)
        dense = np.stack([r[1] for r in reqs])
        ids = (
            np.concatenate([r[2] for r in reqs])
            if any(len(r[2]) for r in reqs)
            else np.zeros((0,), np.int64)
        )
        lengths = np.stack([r[3] for r in reqs])
        return n, rids, dense, ids, lengths

    def _empty(self):
        return (
            np.zeros((0,), np.uint64),
            np.zeros((0, self.num_dense), np.float32),
            np.zeros((0,), np.int64),
            np.zeros((0, self.num_features), np.int32),
        )

    def outstanding(self) -> int:
        """Requests enqueued whose score has not posted yet."""
        with self._mu:
            return self._inflight

    def post_result(self, rid: int, score: float) -> None:
        """Publish one request's score and wake result waiters."""
        with self._mu:
            now = time.monotonic()
            self._inflight = max(0, self._inflight - 1)
            self._results[int(rid)] = (float(score), now)
            for k in [
                k
                for k, (_, t) in self._results.items()
                if now - t > self._RESULT_TTL_S
            ]:
                del self._results[k]
            self._cv_results.notify_all()

    def wait_result(self, rid: int, timeout_us: int) -> Optional[float]:
        """Block until ``rid``'s score posts; None on timeout.  Raises
        :class:`QueueStopped` when the queue stopped with it unanswered."""
        rid = int(rid)
        deadline = time.monotonic() + timeout_us * 1e-6
        with self._mu:
            while rid not in self._results:
                if self._shutdown:
                    raise QueueStopped(
                        f"batching queue shut down with request {rid} "
                        "unanswered"
                    )
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv_results.wait(remaining)
            return self._results.pop(rid)[0]

    def shutdown(self) -> None:
        """Wake every blocked producer/consumer with the shutdown flag."""
        with self._mu:
            self._shutdown = True
            self._cv.notify_all()
            self._cv_results.notify_all()


class InferenceServer:
    """Dynamic-batching model server.

    ``serving_fn(dense [B, num_dense], kjt) -> scores [B]`` must expose
    ``device`` (``inference.modules.ServingModule`` does); each formed
    batch is padded to ``max_batch_size`` examples and moved there.
    ``feature_names`` / ``feature_caps`` (ids per example) fix the wire
    schema.

    ``feature_rows`` (per-feature ``num_embeddings``) +
    ``degrade_on_bad_input=True`` enable graceful degradation: a
    request's out-of-range ids are dropped and its non-finite dense
    features zeroed host-side, and ``predict_ex`` flags the response.
    """

    def __init__(  # graft-check: disable=ctor-too-wide
        self,
        serving_fn: Callable,
        feature_names: Sequence[str],
        feature_caps: Sequence[int],
        num_dense: int,
        max_batch_size: int = 64,
        max_latency_us: int = 2000,
        feature_rows: Optional[Sequence[int]] = None,
        degrade_on_bad_input: bool = False,
        metrics: Optional[MetricsRegistry] = None,
        queue: str = "python",
    ):
        if queue != "python":
            raise ValueError(
                f"queue {queue!r}: the port has only the 'python' queue"
            )
        self._fn = serving_fn
        self.device = torch.device(serving_fn.device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.features = list(feature_names)
        self.caps = list(feature_caps)
        self.num_dense = num_dense
        self.max_batch = max_batch_size
        self.max_latency_us = int(max_latency_us)
        self.feature_rows = (
            list(feature_rows) if feature_rows is not None else None
        )
        self.degrade_on_bad_input = degrade_on_bad_input
        if degrade_on_bad_input and self.feature_rows is None:
            raise ValueError(
                "degrade_on_bad_input needs feature_rows (per-feature "
                "num_embeddings) to know the valid id ranges"
            )
        if self.feature_rows is not None and len(self.feature_rows) != len(
            self.features
        ):
            # an executor-side IndexError would become NaN scores for
            # every batch; fail construction instead
            raise ValueError(
                f"feature_rows has {len(self.feature_rows)} entries for "
                f"{len(self.features)} features"
            )
        self._queue = PyBatchingQueue(
            max_batch_size, max_latency_us, num_dense, len(self.features)
        )
        self._workers: list = []
        self._running = False
        # request id -> degradation reason, set by the executor before the
        # result posts and consumed by predict_ex after the wait
        self._degraded: dict = {}
        self._deg_lock = threading.Lock()
        # batches currently inside an executor (drain waits on them)
        self._executing = 0

    _DEG_MAX = 4096  # unconsumed degradation reasons kept

    def _note_degraded(self, rid: int, why: str, first: bool = False):
        """Merge a degradation reason for ``rid`` (never clobber: the
        client and the executor race on this map); bound the map."""
        with self._deg_lock:
            prev = self._degraded.pop(rid, None)
            self._degraded[rid] = (
                why
                if prev is None
                else (f"{why}; {prev}" if first else f"{prev}; {why}")
            )
            while len(self._degraded) > self._DEG_MAX:
                self._degraded.pop(next(iter(self._degraded)))

    # -- client side -------------------------------------------------------

    def predict(self, dense: np.ndarray, ids_per_feature: Sequence[np.ndarray],
                timeout_us: int = 5_000_000) -> float:
        """Blocking single-example predict."""
        return self.predict_ex(dense, ids_per_feature, timeout_us)[0]

    def predict_ex(
        self,
        dense: np.ndarray,
        ids_per_feature: Sequence[np.ndarray],
        timeout_us: int = 5_000_000,
    ):
        """``predict`` plus the degradation flag: returns ``(score,
        degraded, reason)``."""
        t_start = time.perf_counter()
        dense = np.ascontiguousarray(dense, np.float32)
        if dense.shape != (self.num_dense,):
            raise ValueError(f"dense {dense.shape} != ({self.num_dense},)")
        if len(ids_per_feature) != len(self.features):
            raise ValueError(
                f"expected ids for {len(self.features)} features, got "
                f"{len(ids_per_feature)}"
            )
        truncated = []
        ids_clean = []
        for f, (x, cap) in enumerate(zip(ids_per_feature, self.caps)):
            x = np.asarray(x, np.int64)
            if len(x) > cap:
                if not self.degrade_on_bad_input:
                    raise ValueError(
                        f"feature {self.features[f]}: {len(x)} ids exceed "
                        f"the serving capacity {cap}"
                    )
                x = x[:cap]
                truncated.append(self.features[f])
                self.metrics.counter(
                    counter_key("serving", "truncated_ids", "degraded_count")
                )
            ids_clean.append(x)
        lengths = np.asarray([len(x) for x in ids_clean], np.int32)
        ids = (
            np.concatenate(ids_clean)
            if lengths.sum()
            else np.zeros((0,), np.int64)
        )
        rid = self._queue.enqueue(dense, ids, lengths)
        if truncated:
            self._note_degraded(
                int(rid), f"ids truncated to capacity for {truncated}",
                first=True,
            )
        score = self._queue.wait_result(rid, timeout_us)
        with self._deg_lock:
            reason = self._degraded.pop(int(rid), None)
        self.metrics.counter("serving/request_count")
        self.metrics.observe(
            "serving/request_latency_ms",
            (time.perf_counter() - t_start) * 1e3,
        )
        if score is None:
            self.metrics.counter("serving/request_timeout_count")
            raise TimeoutError(f"predict timed out (request {rid})")
        if reason is not None:
            self.metrics.counter("serving/degraded_response_count")
        return float(score), reason is not None, reason

    # -- server side -------------------------------------------------------

    def start(self, num_executors: int = 1) -> None:
        """Spawn ``num_executors`` executor threads all consuming the same
        batching queue."""
        self._running = True
        for _ in range(num_executors):
            t = threading.Thread(target=self._executor_loop, daemon=True)
            t.start()
            self._workers.append(t)

    def stop(self) -> None:
        self._running = False
        self._queue.shutdown()
        for t in self._workers:
            t.join(timeout=5)
        self._workers = []

    def drain(self, deadline_s: float = 5.0) -> bool:
        """Graceful shutdown: wait (bounded by ``deadline_s``) until every
        accepted request has been answered, then stop.  Returns True when
        the queue fully drained inside the deadline."""
        self.metrics.counter("serving/drain_count")
        start = self._queue.outstanding()
        deadline = time.monotonic() + float(deadline_s)
        left = start
        while time.monotonic() < deadline:
            with self._deg_lock:
                executing = self._executing
            left = self._queue.outstanding() + executing
            if left == 0:
                break
            time.sleep(0.005)
        self.metrics.counter(
            "serving/drained_request_count", float(max(0, start - left))
        )
        if left:
            self.metrics.counter(
                "serving/drain_abandoned_count", float(left)
            )
        self.stop()
        return left == 0

    def _executor_loop(self) -> None:
        while self._running:
            n, rids, dense, ids, lengths = self._queue.dequeue_batch(50_000)
            if n == -1:
                return
            if n == 0:
                continue
            with self._deg_lock:
                self._executing += 1
            try:
                try:
                    scores, reasons = self._run_batch(n, dense, ids, lengths)
                except Exception:
                    # never let one bad batch kill the executor: fail the
                    # affected requests (NaN), count it, keep serving
                    scores = np.full((n,), np.nan, np.float32)
                    reasons = {}
                    self.metrics.counter("serving/executor_error_count")
                    self.metrics.counter("serving/failed_request_count", n)
                if reasons:
                    # flag BEFORE posting so predict_ex's wait can't win
                    # the race against the flag write
                    for i, why in reasons.items():
                        self._note_degraded(int(rids[i]), why)
                for i in range(n):
                    self._queue.post_result(int(rids[i]), float(scores[i]))
            finally:
                with self._deg_lock:
                    self._executing -= 1

    def _sanitize_requests(self, n, dense, ids, lengths):
        """Graceful-degradation tier for formed batches: drop invalid ids
        (negative / ``>= feature_rows``), zero non-finite dense features,
        and report which requests were touched.  Returns (dense, ids,
        lengths, {request index -> reason}); identity when
        ``degrade_on_bad_input`` is off."""
        reasons: dict = {}
        if not self.degrade_on_bad_input:
            return dense, ids, lengths, reasons
        F = len(self.features)
        dense = np.array(dense[:n], np.float32)
        bad_dense = ~np.isfinite(dense)
        bad_rows = np.flatnonzero(bad_dense.any(axis=1))
        if len(bad_rows):
            dense[bad_dense] = 0.0
            per_row = bad_dense.sum(axis=1)
            for i in bad_rows:
                reasons[int(i)] = f"zeroed {int(per_row[i])} non-finite dense"
                self.metrics.counter(
                    counter_key("serving", "non_finite_dense",
                                "degraded_count")
                )
        l = np.asarray(lengths[:n], np.int64)
        V = int(l.sum())
        ids = np.asarray(ids[:V], np.int64)
        # per-id (request, feature) segment index in request-major order
        seg_of = np.repeat(np.arange(n * F), l.reshape(-1))
        rows = np.asarray(self.feature_rows, np.int64)
        keep = (ids >= 0) & (ids < rows[seg_of % F])
        new_lengths = np.asarray(lengths[:n], np.int32).copy()
        if not keep.all():
            dropped = np.bincount(
                seg_of[~keep], minlength=n * F
            ).reshape(n, F)
            new_lengths -= dropped.astype(np.int32)
            ids = ids[keep]
            for i, f in np.argwhere(dropped > 0):
                why = (
                    f"dropped {int(dropped[i, f])} invalid ids for "
                    f"{self.features[f]}"
                )
                i = int(i)
                reasons[i] = f"{reasons[i]}; {why}" if i in reasons else why
                self.metrics.counter(
                    counter_key("serving", "invalid_ids", "degraded_count")
                )
        return dense, ids, new_lengths, reasons

    def _form_kjt(self, n, ids, lengths, batch_rung, caps):
        """Feature-major KJT for a formed batch: the request-major flat id
        buffer regroups with :func:`regroup_request_major`, and lengths
        zero-pad to ``batch_rung`` examples with per-feature capacities
        ``caps``."""
        F = len(self.features)
        l_req = np.zeros((batch_rung, F), np.int32)
        l_req[:n] = lengths[:n]
        values = regroup_request_major(ids, np.asarray(lengths[:n]))
        return KeyedJaggedTensor.from_lengths_packed(
            self.features, values.astype(np.int64, copy=False),
            l_req.T.reshape(-1), caps=caps,
        )

    def _run_batch(self, n, dense, ids, lengths):
        """Pad the formed batch to the serving fn's static shapes, move it
        to the serving device and run; returns (scores [n], {request
        index -> degradation reason})."""
        self.metrics.observe(
            "serving/batch_size", float(n), buckets=_BATCH_SIZE_BUCKETS
        )
        B = self.max_batch
        dense, ids, lengths, reasons = self._sanitize_requests(
            n, dense, ids, lengths
        )
        kjt = self._form_kjt(
            n, ids, lengths, B, [cap * B for cap in self.caps]
        )
        d = np.zeros((B, self.num_dense), np.float32)
        d[:n] = dense[:n]
        with span("serving/run_batch"):
            scores = self._fn(
                torch.from_numpy(d).to(self.device), kjt.to(self.device)
            )
            scores = scores.float().cpu().numpy()
        return scores[:n], reasons
