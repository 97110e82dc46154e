"""Inference server: dynamic batching + the serving module on its device
(``torchrec_tpu/inference/serving.py``).

``predict`` enqueues single requests; the batching queue forms them into
batches (flush at ``max_batch`` requests or ``max_latency_us`` after the
oldest pending one); executor threads pad each formed batch to the
serving function's static shapes, move it to the serving function's
device, run it, and post per-request scores back.

Two interchangeable queues implement the forming policy:

* ``_NativeQueue`` — ctypes adapter over the port's host library
  (``csrc/host/batching_queue.cpp``, built with g++ at first use by
  ``ops/_native.py::load_host_library``), the default, and required by
  ``NetworkInferenceServer``, whose C++ TCP listener
  (``csrc/host/serving_server.cpp``) enqueues into it directly;
* ``PyBatchingQueue`` — a pure-Python mirror with the same policy and
  result semantics.

``NativeInferenceServer`` serves with no Python in the request path: an
artifact's AOTInductor package (``predict_factory.export_native``) run by
the C++ executor loop of ``csrc/host/aoti_executor.cpp`` on the native
queue, behind the C++ TCP front end.

Front ends: ``NetworkInferenceServer`` (length-prefixed binary TCP,
``PredictClient``), ``HttpInferenceServer`` (POST ``/predict``, GET
``/health`` and ``/metrics``) and ``inference/grpc_server.py``.  The
native id transformers (LRU, multi-probe, LFU/DistanceLFU) and their
pure-Python LFU mirror live here too, as in the JAX package.

Threads: several executors may run the serving module at once.  Each
kernel wrapper launches on the CURRENT stream of the thread that calls
it (``ops/tbe.py::_stream_ptr``), and a formed batch's host buffers are
copied into fresh arrays before anything reaches the card, so a native
queue's per-thread dequeue buffers are never read after the executor
moves on.
"""

from __future__ import annotations

import collections
import ctypes
import json
import math
import os
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.obs.registry import MetricsRegistry
from torchrec_tpu_torch.obs.spans import span
from torchrec_tpu_torch.ops._native import load_host_library, load_library
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, regroup_request_major
from torchrec_tpu_torch.utils.device import resolve_device
from torchrec_tpu_torch.utils.profiling import counter_key

# dynamic-batch sizes are small powers-of-two-ish; the default latency
# ladder would lump everything into one bucket
_BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class QueueStopped(RuntimeError):
    """The batching queue was shut down while (or before) this request
    was in it: the replica is stopping, not slow.  The mesh router maps
    it to an immediate retry on another replica."""


def _check_request(dense, ids, lengths, num_dense, num_features):
    """One request in the queue's wire layout: float32 ``dense``
    [num_dense], int64 ``ids`` (request-major), int32 ``lengths``
    [num_features] that sum to ``len(ids)``."""
    dense = np.ascontiguousarray(dense, np.float32).reshape(-1)
    ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
    lengths = np.ascontiguousarray(lengths, np.int32).reshape(-1)
    if dense.shape != (num_dense,):
        raise ValueError(f"dense {dense.shape} != ({num_dense},)")
    if lengths.shape != (num_features,):
        raise ValueError(f"lengths {lengths.shape} != ({num_features},)")
    if (lengths < 0).any() or int(lengths.sum()) != ids.shape[0]:
        raise ValueError(f"lengths {lengths.tolist()} do not cover "
                         f"{ids.shape[0]} ids")
    return dense, ids, lengths


class PyBatchingQueue:
    """Pure-Python dynamic batching queue (``csrc/host/batching_queue.cpp``
    semantics, no native library).

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
        dense, ids, lengths = _check_request(
            dense, ids, lengths, self.num_dense, self.num_features)
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
                # the flush clock restarts for the leftover requests, as
                # in the native queue
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

    def pending(self) -> int:
        """Requests waiting to be formed into a batch."""
        with self._mu:
            return len(self._pending)

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
        """Block until ``rid``'s score posts; None on timeout.  A result
        posted before ``shutdown()`` is still delivered; raises
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


class _NativeQueue:
    """ctypes adapter presenting ``csrc/host/batching_queue.cpp`` through
    the :class:`PyBatchingQueue` call surface.  ``handle`` is the raw
    native pointer the C++ TCP front end attaches to."""

    def __init__(
        self,
        lib,
        max_batch: int,
        max_latency_us: int,
        num_dense: int,
        num_features: int,
        max_ids_hint: int,
    ):
        self._lib = lib
        self.max_batch = int(max_batch)
        self.num_dense = int(num_dense)
        self.num_features = int(num_features)
        self._ids_cap = max(int(max_ids_hint), 1)
        # dequeue buffers are PER-THREAD (several executors drain one
        # queue) and reused across calls: the poll loop runs every 50 ms
        self._bufs = threading.local()
        self._shutdown = False
        self.handle = lib.trt_bq_create(
            max_batch, max_latency_us, num_dense, num_features
        )

    def enqueue(
        self, dense: np.ndarray, ids: np.ndarray, lengths: np.ndarray
    ) -> int:
        """Add one request; returns its id.  Raises :class:`QueueStopped`
        after ``shutdown()`` (the native queue answers id 0)."""
        c = ctypes
        dense, ids, lengths = _check_request(
            dense, ids, lengths, self.num_dense, self.num_features)
        rid = int(self._lib.trt_bq_enqueue(
            self.handle,
            dense.ctypes.data_as(c.POINTER(c.c_float)),
            ids.ctypes.data_as(c.POINTER(c.c_int64)),
            lengths.ctypes.data_as(c.POINTER(c.c_int32)),
        ))
        if rid == 0:
            raise QueueStopped("batching queue is shut down; request refused")
        return rid

    def dequeue_batch(self, timeout_us: int):
        """Same ``(n, rids, dense, ids, lengths)`` contract as
        :meth:`PyBatchingQueue.dequeue_batch`; the native buffer-resize
        protocol (-2) is retried internally.  The returned arrays are
        views of this thread's reusable buffers, valid until the same
        thread's next call."""
        c = ctypes
        b = self._bufs
        if getattr(b, "rids", None) is None:
            b.rids = np.empty((self.max_batch,), np.uint64)
            b.dense = np.empty((self.max_batch, self.num_dense), np.float32)
            b.lengths = np.empty(
                (self.max_batch, self.num_features), np.int32
            )
            b.ids = np.empty((self._ids_cap,), np.int64)
        while True:
            rids, dense, lengths = b.rids, b.dense, b.lengths
            if b.ids.shape[0] < self._ids_cap:
                b.ids = np.empty((self._ids_cap,), np.int64)
            ids_buf = b.ids
            cap = c.c_int64(ids_buf.shape[0])
            n = self._lib.trt_bq_dequeue_batch(
                self.handle, timeout_us,
                rids.ctypes.data_as(c.POINTER(c.c_uint64)),
                dense.ctypes.data_as(c.POINTER(c.c_float)),
                ids_buf.ctypes.data_as(c.POINTER(c.c_int64)),
                c.byref(cap),
                lengths.ctypes.data_as(c.POINTER(c.c_int32)),
            )
            if n == -2:
                # buffer too small: the queue wrote the needed size
                self._ids_cap = int(cap.value)
                continue
            if n <= 0:
                return (
                    (-1 if n == -1 else 0),
                    rids[:0], dense[:0], ids_buf[:0], lengths[:0],
                )
            return n, rids[:n], dense[:n], ids_buf[: cap.value], lengths[:n]

    def pending(self) -> int:
        """Requests waiting in the native queue."""
        return int(self._lib.trt_bq_pending(self.handle))

    def outstanding(self) -> int:
        """Requests enqueued whose score has not posted yet."""
        return int(self._lib.trt_bq_outstanding(self.handle))

    def post_result(self, rid: int, score: float) -> None:
        s = np.asarray([score], np.float32)
        self._lib.trt_bq_post_result(
            self.handle, int(rid),
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 1,
        )

    def wait_result(self, rid: int, timeout_us: int) -> Optional[float]:
        """``rid``'s score, None on timeout; raises :class:`QueueStopped`
        when the queue stopped with it unanswered."""
        out = np.empty((1,), np.float32)
        n = self._lib.trt_bq_wait_result(
            self.handle, int(rid), timeout_us,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 1,
        )
        if n < 0:
            raise QueueStopped(
                f"batching queue shut down with request {rid} unanswered")
        return float(out[0]) if n > 0 else None

    def shutdown(self) -> None:
        self._shutdown = True
        self._lib.trt_bq_shutdown(self.handle)


class _NativeTransformerBase:
    """Shared ctypes marshalling for the native id transformers; concrete
    classes set ``_prefix`` and construct ``self._h``."""

    _prefix: str

    def transform(self, ids: np.ndarray):
        """ids [n] int64 -> (slots [n], evicted_global, evicted_slot)."""
        ids = np.ascontiguousarray(ids, np.int64)
        n = len(ids)
        slots = np.empty((n,), np.int64)
        ev_g = np.empty((n,), np.int64)
        ev_s = np.empty((n,), np.int64)
        ev_n = ctypes.c_int64(0)
        i64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
        getattr(self._lib, f"{self._prefix}_transform")(
            self._h, i64p(ids), n, i64p(slots), i64p(ev_g), i64p(ev_s),
            ctypes.byref(ev_n),
        )
        k = ev_n.value
        return slots, ev_g[:k], ev_s[:k]

    def __len__(self):
        return int(getattr(self._lib, f"{self._prefix}_size")(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            getattr(self._lib, f"{self._prefix}_destroy")(h)
            self._h = None


class IdTransformer(_NativeTransformerBase):
    """Native LRU id transformer: unbounded int64 ids map to ``capacity``
    slots; when full, the least-recently-used slot is evicted."""

    _prefix = "trt_idt"

    def __init__(self, capacity: int):
        self._lib = load_host_library()
        self._h = self._lib.trt_idt_create(capacity)
        self.capacity = capacity


class MpIdTransformer(_NativeTransformerBase):
    """Native multi-probe hash transformer (MPZCH): each id probes a fixed
    hash-derived window of ``max_probe`` slots, with windowed-LRU
    eviction.  The window is restart-stable (a pure function of the id's
    hash); the slot within it is first-empty-wins."""

    _prefix = "trt_mpidt"

    def __init__(self, capacity: int, max_probe: int = 8):
        self._lib = load_host_library()
        self._h = self._lib.trt_mpidt_create(capacity, max_probe)
        self.capacity = capacity
        self.max_probe = max_probe


class LfuIdTransformer(_NativeTransformerBase):
    """Native LFU (min count bucket, LRU inside) or DistanceLFU (min
    count/distance^decay) id transformer; one ``transform`` call is one
    iteration."""

    _prefix = "trt_lfu"

    def __init__(self, capacity: int, policy: str = "lfu",
                 decay_exponent: float = 1.0):
        self._lib = load_host_library()
        pol = {"lfu": 0, "distance_lfu": 1}[policy]
        self._h = self._lib.trt_lfu_create(capacity, pol, decay_exponent)
        self.capacity = capacity
        self.policy = policy


class PyLfuIdTransformer:
    """Pure-Python counterpart of :class:`LfuIdTransformer` (same
    ``transform``/``__len__`` contract, no native library).

    ``"lfu"`` evicts the min-count slot (LRU within a count),
    ``"distance_lfu"`` scores ``count / distance^decay`` so stale
    frequency ages out.  Slot placement may differ from the native
    transformer's under ties; eviction is an O(capacity) vectorized
    argmin."""

    def __init__(self, capacity: int, policy: str = "lfu",
                 decay_exponent: float = 1.0):
        """``capacity`` slots; ``policy`` is "lfu" | "distance_lfu";
        ``decay_exponent`` is the distance-aging power (distance_lfu)."""
        self.capacity = int(capacity)
        self.policy = policy
        self.decay_exponent = float(decay_exponent)
        self._slot_of: dict = {}
        self._id_of = np.full((self.capacity,), -1, np.int64)
        self._count = np.zeros((self.capacity,), np.float64)
        self._last = np.zeros((self.capacity,), np.float64)
        self._clock = 0.0
        self._next_fresh = 0

    def transform(self, ids: np.ndarray):
        """ids [n] int64 -> (slots [n], evicted_global, evicted_slot),
        in stream order, stateful."""
        ids = np.ascontiguousarray(ids, np.int64)
        slots = np.empty((len(ids),), np.int64)
        ev_g, ev_s = [], []
        for i, gid in enumerate(ids):
            gid = int(gid)
            self._clock += 1.0
            s = self._slot_of.get(gid)
            if s is None:
                if self._next_fresh < self.capacity:
                    s = self._next_fresh
                    self._next_fresh += 1
                else:
                    if self.policy == "distance_lfu":
                        dist = np.maximum(self._clock - self._last, 1.0)
                        score = self._count / dist ** self.decay_exponent
                    else:
                        # min count bucket, LRU inside: lexicographic
                        # (count, last) via a large count weight
                        score = self._count * 1e15 + self._last
                    s = int(np.argmin(score))
                    ev_g.append(int(self._id_of[s]))
                    ev_s.append(s)
                    del self._slot_of[int(self._id_of[s])]
                self._slot_of[gid] = s
                self._id_of[s] = gid
                self._count[s] = 0.0
            self._count[s] += 1.0
            self._last[s] = self._clock
            slots[i] = s
        return (
            slots,
            np.asarray(ev_g, np.int64),
            np.asarray(ev_s, np.int64),
        )

    def __len__(self):
        return len(self._slot_of)


class InferenceServer:
    """Dynamic-batching model server.

    ``serving_fn(dense [B, num_dense], kjt) -> scores [B]`` must expose
    ``device`` (``inference.modules.ServingModule`` does); each formed
    batch is padded to ``max_batch_size`` examples and moved there.
    ``feature_names`` / ``feature_caps`` (ids per example) fix the wire
    schema; ``queue`` is ``"native"`` (the default) or ``"python"``.

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
        queue: str = "native",
    ):
        self._fn = serving_fn
        # a native server (no Python serving function) sets its own
        self.device = (None if serving_fn is None
                       else torch.device(serving_fn.device))
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
        if queue == "native":
            self._lib = load_host_library()
            self._queue = _NativeQueue(
                self._lib, max_batch_size, max_latency_us, num_dense,
                len(self.features),
                max_ids_hint=max_batch_size * max(self.caps, default=1)
                * len(self.features),
            )
        elif queue == "python":
            self._lib = None
            self._queue = PyBatchingQueue(
                max_batch_size, max_latency_us, num_dense, len(self.features)
            )
        else:
            raise ValueError(f"unknown queue kind {queue!r}")
        self._workers: list = []
        self._running = False
        # request id -> degradation reason, set by the executor before the
        # result posts and consumed by predict_ex after the wait; bounded
        # (TCP requests never consume theirs)
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

    def drain(
        self,
        deadline_s: float = 5.0,
        started_outstanding: Optional[int] = None,
    ) -> bool:
        """Graceful shutdown: wait (bounded by ``deadline_s``) until every
        accepted request has been answered, then stop.  Returns True when
        the queue fully drained inside the deadline.
        ``started_outstanding``: the in-flight count a front end
        snapshotted before closing its listener."""
        self.metrics.counter("serving/drain_count")
        start = (
            int(started_outstanding)
            if started_outstanding is not None
            else self._queue.outstanding()
        )
        deadline = time.monotonic() + float(deadline_s)
        while time.monotonic() < deadline and self._left():
            time.sleep(0.005)
        left = self._left()
        self.metrics.counter(
            "serving/drained_request_count", float(max(0, start - left))
        )
        if left:
            self.metrics.counter(
                "serving/drain_abandoned_count", float(left)
            )
        self.stop()
        return left == 0

    def _left(self) -> int:
        """Requests unanswered plus batches inside an executor."""
        with self._deg_lock:
            executing = self._executing
        return self._queue.outstanding() + executing

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
        ``caps``.  Every buffer is a fresh array (never a view of the
        queue's)."""
        F = len(self.features)
        l_req = np.zeros((batch_rung, F), np.int32)
        l_req[:n] = lengths[:n]
        values = regroup_request_major(ids, np.asarray(lengths[:n]))
        return KeyedJaggedTensor.from_lengths_packed(
            self.features, values.astype(np.int64, copy=False),
            l_req.T.reshape(-1), caps=caps,
        )

    def _device_inputs(self, n, dense, ids, lengths, batch_rung, caps):
        """The formed batch padded to ``batch_rung`` examples and
        per-feature capacities ``caps``, on the serving device: (dense
        [batch_rung, num_dense], KJT)."""
        kjt = self._form_kjt(n, ids, lengths, batch_rung, caps)
        d = np.zeros((batch_rung, self.num_dense), np.float32)
        d[:n] = dense[:n]
        return torch.from_numpy(d).to(self.device), kjt.to(self.device)

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
        args = self._device_inputs(n, dense, ids, lengths, B,
                                   [cap * B for cap in self.caps])
        with span("serving/run_batch", n=n):
            scores = self._fn(*args).float().cpu().numpy()
        return scores[:n], reasons


class NetworkInferenceServer(InferenceServer):
    """InferenceServer + the native TCP front end
    (``csrc/host/serving_server.cpp``).

    The wire protocol is a length-prefixed binary mirror of
    ``predictor.proto`` (see the .cpp header comment); network requests
    and in-process ``predict()`` calls coalesce into the same batches.
    Needs ``queue="native"`` (the default)."""

    def __init__(self, *args, request_timeout_us: int = 10_000_000, **kwargs):
        super().__init__(*args, **kwargs)
        if self._lib is None:
            raise ValueError(
                "NetworkInferenceServer needs the native batching queue "
                "(queue='native'); the C++ TCP front end enqueues into "
                "the native structure directly"
            )
        caps = np.asarray(self.caps, np.int32)
        self._srv = self._lib.trt_srv_create(
            self._queue.handle, self.num_dense, len(self.features),
            caps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            request_timeout_us,
        )
        self.port: Optional[int] = None

    def serve(self, port: int = 0, num_executors: int = 1) -> int:
        """Bind the TCP listener on 127.0.0.1, then start executors;
        returns the bound port (``port=0`` picks an ephemeral one)."""
        bound = self._lib.trt_srv_start(self._srv, port)
        if bound < 0:
            raise OSError(f"could not bind serving port {port}")
        self.port = bound
        self.start(num_executors)
        return bound

    def stop(self) -> None:
        if self._srv:
            self._lib.trt_srv_stop(self._srv)
        super().stop()
        if self._srv:
            self._lib.trt_srv_destroy(self._srv)
            self._srv = None

    def drain(self, deadline_s: float = 5.0) -> bool:
        """Graceful TCP shutdown: quiesce the native front end (close the
        listener, let every connection finish the request it is mid-way
        through), then drain the batching queue and stop.  The deadline
        bounds both phases together."""
        deadline = time.monotonic() + float(deadline_s)
        # snapshot BEFORE the quiesce, which waits for in-flight requests
        started = self._queue.outstanding()
        inflight_left = 0
        if self._srv:
            inflight_left = int(
                self._lib.trt_srv_quiesce(self._srv, int(deadline_s * 1e3))
            )
            if inflight_left:
                self.metrics.counter(
                    "serving/drain_torn_connection_count",
                    float(inflight_left),
                )
        remaining = max(0.1, deadline - time.monotonic())
        return (super().drain(remaining, started_outstanding=started)
                and inflight_left == 0)

    def __del__(self):
        if getattr(self, "_srv", None):
            self._lib.trt_srv_stop(self._srv)
            self._lib.trt_srv_destroy(self._srv)
            self._srv = None


# torch dtype -> c10::ScalarType code (the executor's constants)
_SCALAR_TYPES = {torch.uint8: 0, torch.int8: 1, torch.int16: 2,
                 torch.int32: 3, torch.int64: 4, torch.float16: 5,
                 torch.float32: 6, torch.float64: 7, torch.bool: 11,
                 torch.bfloat16: 15}


def default_torch_lib() -> ctypes.CDLL:
    """The native executor's library (``csrc/host/aoti_executor.cpp``
    linked to the installed libtorch), built at first use: where the JAX
    package's ``default_tf_lib`` located libtensorflow_cc."""
    return load_library("host/aoti_executor.cpp")


class NativeInferenceServer(NetworkInferenceServer):
    """Serving with NO Python in the request path.

    Reference: ``inference/server.cpp:50``, where the C++ server executes
    the exported model natively.  The artifact's AOTInductor package
    (``predict_factory.export_native``) runs in the C++ executor of
    ``csrc/host/aoti_executor.cpp``; its loop drains the native batching
    queue, pads each formed batch to the package's static shapes,
    regroups it feature-major, runs the package on its device and posts
    the scores, so a request that arrives over the C++ TCP front end
    (``csrc/host/serving_server.cpp``) is served entirely in C++, the
    lookups included (the package's ``trt::`` operators,
    ``csrc/torch_ops.cpp``).  Python only opens, starts and stops;
    in-process ``predict()`` calls coalesce into the same batches.

    The constructor loads the artifact's tables and dense weights onto the
    export's device (``load_packaged_model``; raises ``RuntimeError``
    there with no card) and opens the package with them as user-managed
    constants: read in place, never copied into the package.  One
    executor for every device (the JAX package's ``executor="tf" |
    "pjrt"``): the package's own."""

    def __init__(
        self,
        artifact_dir: str,
        max_latency_us: int = 2000,
        request_timeout_us: int = 10_000_000,
    ):
        from torchrec_tpu_torch.inference.predict_factory import flat_serving

        with open(os.path.join(artifact_dir, "native_manifest.json")) as f:
            mani = json.load(f)
        if "aoti" not in mani["formats"]:
            raise ValueError("artifact has no AOTInductor package; re-run "
                             "export_native(formats=('aoti', ...))")
        B = int(mani["batch_size"])
        super().__init__(
            None,  # never called: execution is native
            feature_names=mani["features"],
            feature_caps=mani["caps"],
            num_dense=mani["num_dense"],
            max_batch_size=B,
            max_latency_us=max_latency_us,
            request_timeout_us=request_timeout_us,
        )
        self._ax = self._loop = None
        self.device = resolve_device(mani["device"])
        if self.device.type == "cuda":
            from torchrec_tpu_torch.ops import custom_ops

            custom_ops.load_ops()
        self._module, _ = flat_serving(artifact_dir, self.device,
                                       mani["lookup_kernel"], B)
        state = {**dict(self._module.named_parameters()),
                 **dict(self._module.named_buffers())}
        missing = [n for n in mani["constants"] if n not in state]
        if missing:
            raise RuntimeError(f"native executor open failed: constants "
                               f"{missing} are not in the artifact's module")
        # kept alive (and contiguous) as long as the executor reads them
        self._constants = [state[n].contiguous() for n in mani["constants"]]
        c = ctypes
        n = len(self._constants)
        dims = [d for t in self._constants for d in t.shape]
        self._axlib = default_torch_lib()
        self._ax = self._axlib.trt_aoti_open(
            os.path.join(artifact_dir, "model_aoti.pt2").encode(),
            int(self.device.type == "cuda"),
            (self.device.index or 0) if self.device.type == "cuda" else -1,
            n,
            (c.c_char_p * n)(*[s.encode() for s in mani["constants"]]),
            (c.c_void_p * n)(*[t.data_ptr() for t in self._constants]),
            (c.c_int * n)(*[_SCALAR_TYPES[t.dtype]
                            for t in self._constants]),
            (c.c_int * n)(*[t.dim() for t in self._constants]),
            (c.c_int64 * len(dims))(*dims),
            B, self.num_dense, sum(mani["caps"]) * B, len(self.features),
        )
        if not self._ax:
            raise RuntimeError("native executor open failed: "
                               + self._axlib.trt_aoti_last_error().decode())

    def start(self, num_executors: int = 1) -> None:
        """Start the C++ executor loop (``num_executors`` is taken for
        the interface's sake: the loop is one thread, the package runs
        each batch on its device)."""
        hl = self._lib
        self._caps_arr = np.asarray(self.caps, np.int32)
        self._running = True
        self._loop = self._axlib.trt_aoti_loop_start(
            self._queue.handle,
            ctypes.cast(hl.trt_bq_dequeue_batch, ctypes.c_void_p),
            ctypes.cast(hl.trt_bq_post_result, ctypes.c_void_p),
            self._ax, self._caps_arr.ctypes.data)
        if not self._loop:
            raise RuntimeError("native executor loop failed to start: "
                               + self._axlib.trt_aoti_last_error().decode())

    def run(self, dense: np.ndarray, values: np.ndarray,
            lengths: np.ndarray) -> np.ndarray:
        """One batch straight through the executor, at the package's
        static shapes (dense [B, num_dense] float32, values [sum(caps) *
        B] int32 in the feature-major layout the loop builds, lengths
        [F * B] int32): the scores [B].  Raises with the executor's
        message if the run fails."""
        B, F = self.max_batch, len(self.features)
        args = (np.ascontiguousarray(dense, np.float32),
                np.ascontiguousarray(values, np.int32),
                np.ascontiguousarray(lengths, np.int32))
        shapes = ((B, self.num_dense), (sum(self.caps) * B,), (F * B,))
        if tuple(a.shape for a in args) != shapes:
            raise ValueError(f"inputs {[a.shape for a in args]} != {shapes}")
        out = np.empty((B,), np.float32)
        n = self._axlib.trt_aoti_run(self._ax, *(a.ctypes.data for a in args),
                                     out.ctypes.data, B)
        if n < 0:
            raise RuntimeError("native executor run failed: "
                               + self._axlib.trt_aoti_run_error(
                                   self._ax).decode())
        return out[:n]

    def loop_stats(self) -> dict:
        """The loop's batches run and, of them, failed (posted NaN)."""
        out = (ctypes.c_int64 * 2)()
        if self._loop:
            self._axlib.trt_aoti_loop_stats(self._loop, out)
        return {"batches": int(out[0]), "failed_batches": int(out[1])}

    def stop(self) -> None:
        """Idempotent teardown: the TCP front first (no new requests), then
        the queue, the loop and the executor; the tables are released."""
        if self._srv:
            self._lib.trt_srv_stop(self._srv)
        self._running = False
        self._queue.shutdown()
        if self._loop:
            self._axlib.trt_aoti_loop_stop(self._loop)
            self._loop = None
        if self._ax:
            self._axlib.trt_aoti_close(self._ax)
            self._ax = None
        self._module = self._constants = None
        if self._srv:
            self._lib.trt_srv_destroy(self._srv)
            self._srv = None


class PredictClient:
    """Client for :class:`NetworkInferenceServer`'s binary protocol (the
    ``predictor.proto`` PredictionRequest/Response shape)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        import socket as _socket

        self._sock = _socket.create_connection((host, port))
        self._sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)

    def predict(
        self, dense: np.ndarray, ids_per_feature: Sequence[np.ndarray]
    ) -> float:
        """Blocking predict over the wire; raises on server-side failure."""
        import struct

        dense = np.ascontiguousarray(dense, np.float32)
        parts = [
            struct.pack("<I", dense.shape[0]),
            dense.tobytes(),
            struct.pack("<I", len(ids_per_feature)),
        ]
        for x in ids_per_feature:
            x = np.ascontiguousarray(x, np.int64)
            parts.append(struct.pack("<I", x.shape[0]))
            parts.append(x.tobytes())
        payload = b"".join(parts)
        self._sock.sendall(struct.pack("<I", len(payload)) + payload)
        (plen,) = struct.unpack("<I", self._recv_exact(4))
        body = self._recv_exact(plen)
        status = body[0]
        (score,) = struct.unpack("<f", body[1:5])
        if status == 2:
            raise ValueError("server rejected request as malformed")
        if status == 1:
            raise TimeoutError("server-side predict failed or timed out")
        return float(score)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed connection")
            buf += chunk
        return buf

    def close(self) -> None:
        self._sock.close()


class HttpInferenceServer:
    """HTTP/JSON front end over an ``InferenceServer``.

    POST ``/predict`` takes ``{"float_features": [..num_dense floats..],
    "id_list_features": {"<feature>": [ids...], ...}}`` and answers
    ``{"score": <float>, "degraded": <bool>}`` (with ``degraded_reason``
    when set).  GET ``/health`` answers 200; GET ``/metrics`` serves the
    inner server's registry as Prometheus text.  Handler threads block
    inside ``InferenceServer.predict_ex``, so concurrent HTTP requests
    coalesce into the same batches as other callers."""

    def __init__(
        self,
        inner: InferenceServer,
        predict_timeout_us: int = 5_000_000,
    ):
        self.inner = inner
        self.predict_timeout_us = int(predict_timeout_us)
        self.port: Optional[int] = None
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        # set by drain(): keep-alive handler threads outlive the
        # listener, so they must refuse NEW requests themselves
        self._draining = False

    def serve(self, port: int = 0, num_executors: int = 1) -> int:
        """Bind 127.0.0.1 + start executors; returns the bound port."""
        import http.server
        import json as _json
        import socketserver

        inner = self.inner
        srv = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # a reply goes out in two writes (headers, then body): with
            # Nagle's algorithm on, the body waits for the client's
            # delayed ACK of the headers, about 40 ms a keep-alive request
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet by default
                pass

            def _reply(self, code: int, obj) -> None:
                body = _json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._reply(200, {"status": "ok"})
                elif self.path == "/metrics":
                    body = inner.metrics.to_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                if srv._draining:
                    # the listener is closed but THIS keep-alive
                    # connection outlived it: a complete 503, then close
                    self.close_connection = True
                    self._reply(
                        503, {"error": "server draining for restart"}
                    )
                    return
                if self.path != "/predict":
                    self._reply(404, {"error": "unknown path"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = _json.loads(self.rfile.read(n))
                    dense = np.asarray(req["float_features"], np.float32)
                    by_name = req.get("id_list_features", {})
                    ids = [
                        np.asarray(by_name.get(f, []), np.int64)
                        for f in inner.features
                    ]
                except (ValueError, KeyError, TypeError) as e:
                    self._reply(400, {"error": f"malformed request: {e}"})
                    return
                try:
                    score, degraded, reason = inner.predict_ex(
                        dense, ids, timeout_us=srv.predict_timeout_us
                    )
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                except TimeoutError as e:
                    self._reply(503, {"error": str(e)})
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                else:
                    if not math.isfinite(score):
                        # an executor failure posts NaN; bare NaN is not
                        # RFC JSON: answer a typed 500 instead
                        self._reply(
                            500,
                            {"error": "executor failed (request scored "
                                      f"{score!r})"},
                        )
                        return
                    body = {"score": score, "degraded": degraded}
                    if degraded:
                        body["degraded_reason"] = reason
                    self._reply(200, body)

        class _Srv(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True

        self._httpd = _Srv(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self.inner.start(num_executors)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.inner.stop()

    def drain(self, deadline_s: float = 5.0) -> bool:
        """Graceful HTTP shutdown: close the listener first (in-flight
        handler threads keep blocking inside ``predict_ex`` and answer
        normally), then drain the inner server's queue; one deadline
        covers both."""
        deadline = time.monotonic() + float(deadline_s)
        # flip BEFORE the listener closes: keep-alive handler threads
        # must 503-and-close any NEW request themselves
        self._draining = True
        # snapshot BEFORE the listener teardown, which can outlast a fast
        # request
        started = self.inner._queue.outstanding()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=max(0.0, deadline - time.monotonic()))
            self._thread = None
        return self.inner.drain(
            max(0.1, deadline - time.monotonic()),
            started_outstanding=started,
        )


def install_sigterm_drain(server, deadline_s: float = 5.0):
    """Register a SIGTERM handler that drains ``server`` (anything with
    ``drain(deadline_s)``) before the process dies, then restores the
    default disposition and re-delivers SIGTERM, so the process still
    exits with the conventional signal status.  Must run on the main
    thread; returns the previous handler."""
    import signal as _signal

    def _handler(signum, frame):
        del frame
        try:
            server.drain(deadline_s)
        finally:
            _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    return _signal.signal(_signal.SIGTERM, _handler)
