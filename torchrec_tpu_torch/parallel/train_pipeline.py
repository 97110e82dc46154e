"""Train pipelines with capacity bucketing (a subset of
``torchrec_tpu/parallel/train_pipeline.py``) on one device.

``TrainPipelineBase`` keeps a queue of batches already on the device
(``depth + 1`` deep) filled from a background :class:`DataLoadingThread`,
so batch construction on the host overlaps the step before it;
``TrainPipelineSparseDist`` keeps it deeper.  ``BucketedTrainPipeline``
adds capacity bucketing: each batch's per-key occupancy rounds up a
geometric ladder (``sparse/jagged_tensor.py::bucket_ladder``), the batch
is repacked to that capacity signature on the host, and a
:class:`BucketedStepCache` runs it through the train step of that
signature's ``DistributedModelParallel.with_feature_caps`` clone.  Every
clone shares the one train state; rungs never fall below occupancy, so a
bucketed step gives the same numbers as the full-capacity step.

The port compiles nothing: a signature's "program" is its clone's eager
``train_step``, built on first use (the JAX package AOT-compiles one XLA
program per signature).  ``BucketingConfig.kernels`` names the clones'
kernels, ``{"pooled": "tbe"|"dedup", "update": "tbe"|"dedup"}``, where the
JAX package selects them process-wide around each compile.

Left out: the multi-device grouping (one local batch per step here), the
dedup overflow guard ``_dedup_overflow_guard`` (it acts on the row-wise
dedup and hierarchical layouts, which are not ported), ``warmup`` (there
is nothing to precompile), the semi-sync and staged pipelines, the
eval pipeline, buffer donation, the touched-row and kernel-stats ledgers,
the guardrail scalars of ``scalar_metrics`` (``dedup_overflow``,
``id_violations``) and ``invalidate_prefetch`` (ROADMAP A7).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import (
    Any, Callable, Deque, Dict, Iterator, List, Mapping, Optional,
    Sequence, Tuple,
)

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.obs.spans import span
from torchrec_tpu_torch.parallel.model_parallel import stack_batches
from torchrec_tpu_torch.sparse.jagged_tensor import bucketed_cap
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device
from torchrec_tpu_torch.utils.profiling import PaddingStats


class DataLoadingThread:
    """Background batch loader: a daemon thread drains the source
    iterator into a bounded queue so batch construction overlaps device
    work.  ``get()`` returns the next item or ``None`` when the source is
    exhausted; iterate the loader instead for sources that yield ``None``.
    An exception of the source re-raises in the consumer on the next
    ``get()``.  ``stop()`` ends the thread early and is idempotent."""

    def __init__(self, it: Iterator[Any], prefetch: int = 2):
        q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, prefetch))
        stop = threading.Event()
        done = threading.Event()
        error: List[BaseException] = []  # 0-or-1 slot

        # the worker captures only these locals, never self: an abandoned
        # loader stays collectable, its __del__ sets the stop event and
        # the worker exits
        def worker():
            try:
                for item in it:
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # re-raised in the consumer
                error.append(e)
            finally:
                done.set()

        self._q, self._stop, self._done, self._error = q, stop, done, error
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _get(self) -> Tuple[bool, Optional[Any]]:
        """(True, item), or (False, None) at exhaustion."""
        while True:
            try:
                return True, self._q.get_nowait()
            except queue.Empty:
                pass
            if self._done.is_set():
                # drain what arrived between the two checks, then surface a
                # producer error once; exhaustion is sticky after that
                try:
                    return True, self._q.get_nowait()
                except queue.Empty:
                    pass
                if self._error:
                    raise self._error.pop()
                return False, None
            if self._stop.is_set():
                return False, None
            try:
                return True, self._q.get(timeout=0.05)
            except queue.Empty:
                continue

    def get(self) -> Optional[Any]:
        return self._get()[1]

    def __iter__(self):
        return self

    def __next__(self):
        ok, item = self._get()
        if not ok:
            raise StopIteration
        return item

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def __del__(self):
        stop = getattr(self, "_stop", None)  # None if __init__ failed
        if stop is not None:
            stop.set()


class TrainPipelineBase:
    """Pipelined train loop on one device: while step ``i`` runs, batch
    ``i + 1`` is built on a background thread and copied to the device.
    ``step_fn`` is ``(state, batch) -> (state, metrics)`` (e.g.
    ``dmp.train_step``); the live state is ``self.state``."""

    depth = 1

    def __init__(
        self,
        step_fn: Optional[Callable[[Any, Batch], Any]],
        state: Any,
        device: DeviceLike = None,
    ):
        self._step = step_fn
        self.state = state
        self.device = resolve_device(device)
        self._queue: Deque[Any] = collections.deque()
        self._exhausted = False
        self._loader: Optional[DataLoadingThread] = None
        # the iterator the loader drains, compared by identity: a new
        # iterator retires the old loader
        self._loader_it: Optional[Iterator[Batch]] = None
        self._last_metrics: Optional[Dict[str, Any]] = None

    def _pull_locals_async(self, it: Iterator[Batch]) -> Optional[List[Batch]]:
        """The step's local batches (one at one device) from the
        background loader; None at the end of the source."""
        if self._loader is None or self._loader_it is not it:
            if self._loader is not None:
                self._loader.stop()
            self._loader = DataLoadingThread(it, prefetch=self.depth + 1)
            self._loader_it = it
        ok, item = self._loader._get()
        return [item] if ok else None

    def _stack_and_put(self, locals_: List[Batch]) -> Batch:
        return stack_batches(locals_).to(self.device)

    def _queue_item(self, it: Iterator[Batch]):
        locals_ = self._pull_locals_async(it)
        if locals_ is None:
            return None
        return self._stack_and_put(locals_)

    def _fill(self, it: Iterator[Batch]) -> None:
        while not self._exhausted and len(self._queue) <= self.depth:
            b = self._queue_item(it)
            if b is None:
                self._exhausted = True
                return
            self._queue.append(b)

    def progress(self, it: Iterator[Batch]):
        """Run one step; returns its metrics.  Raises ``StopIteration``
        when the source and the queue are empty."""
        self._fill(it)
        if not self._queue:
            raise StopIteration
        batch = self._queue.popleft()
        with span("pipeline/step_dispatch"):
            self.state, metrics = self._step(self.state, batch)
        self._last_metrics = metrics
        self._fill(it)
        return metrics

    def scalar_metrics(self, prefix: str = "pipeline") -> Dict[str, float]:
        """The last step's ``id_overflow`` summed over keys, under
        ``{prefix}/id_overflow`` (reads the device count: call it at
        metric-collection cadence, not every step)."""
        m = self._last_metrics
        if not isinstance(m, dict) or "id_overflow" not in m:
            return {}
        return {f"{prefix}/id_overflow": float(m["id_overflow"].sum())}


class TrainPipelineSparseDist(TrainPipelineBase):
    """The base pipeline with two batches in flight (the reference's
    three-stage sparse-dist pipeline; at one device there is no input
    dist to overlap, so only the queue depth remains)."""

    depth = 2


@dataclasses.dataclass(frozen=True)
class BucketingConfig:
    """Capacity-bucketing policy.  ``floor``: the smallest ladder rung;
    ``growth``: the rung factor; ``max_programs``: the bound on distinct
    signatures (the full-capacity signature owns one slot; past the bound
    a new signature rounds up to the smallest cached one that dominates
    it, or to full capacity); ``kernels``: the kernels of every
    signature's step, ``{"pooled": ..., "update": ...}`` with values
    ``"tbe"`` or ``"dedup"``."""

    floor: int = 8
    growth: float = 2.0
    max_programs: int = 8
    kernels: Optional[Mapping[str, str]] = None


class BucketedStepCache:
    """Signature-keyed train steps over one live train state.  A signature
    is the per-feature bucketed capacities in the batch's key order; each
    owns a ``dmp.with_feature_caps`` clone, built on first use.
    :meth:`resolve` bounds their number (``config.max_programs``)."""

    def __init__(
        self,
        dmp,
        config: Optional[BucketingConfig] = None,
        stats: Optional[PaddingStats] = None,
    ):
        self._dmp = dmp
        self.config = config or BucketingConfig()
        kernels = dict(self.config.kernels or {})
        unknown = set(kernels) - {"pooled", "update"}
        if unknown:
            raise ValueError(f"unknown kernel families {sorted(unknown)}")
        self._kernels = kernels
        self.stats = stats if stats is not None else PaddingStats()
        self._keys: Optional[Tuple[str, ...]] = None
        self._full_sig: Optional[Tuple[int, ...]] = None
        self._admitted: set = set()
        self._entries: Dict[Tuple[int, ...], Any] = {}

    def _bind_keys(self, keys: Sequence[str]) -> None:
        keys = tuple(keys)
        if self._keys is None:
            self._keys = keys
            self._full_sig = tuple(
                int(self._dmp.feature_caps[k]) for k in keys)
        elif keys != self._keys:
            raise ValueError(f"batch keys changed mid-stream: {keys} != "
                             f"{self._keys}")

    @property
    def full_signature(self) -> Optional[Tuple[int, ...]]:
        return self._full_sig

    def signature(
        self, keys: Sequence[str], occupancy: Sequence[int]
    ) -> Tuple[int, ...]:
        """Round a per-key occupancy profile up the ladder."""
        self._bind_keys(keys)
        cfg = self.config
        return tuple(
            bucketed_cap(occ, cap, cfg.floor, cfg.growth)
            for occ, cap in zip(occupancy, self._full_sig)
        )

    def resolve(
        self, keys: Sequence[str], sig: Sequence[int]
    ) -> Tuple[int, ...]:
        """Admit a signature, or round it up to a cached one that
        dominates it (or to full capacity) once ``max_programs`` are in
        use; capacities only grow, so the result stays exact."""
        self._bind_keys(keys)
        sig = tuple(int(c) for c in sig)
        if sig == self._full_sig or sig in self._admitted:
            return sig
        # the full signature owns the reserved slot
        if len(self._admitted) < self.config.max_programs - 1:
            self._admitted.add(sig)
            return sig
        self.stats.record_fallback()
        dominating = [s for s in self._admitted
                      if all(a >= b for a, b in zip(s, sig))]
        if dominating:
            return min(dominating, key=sum)
        return self._full_sig

    def train_program(self, sig: Sequence[int]):
        """The train step of a signature's clone."""
        sig = tuple(sig)
        dmp = self._entries.get(sig)
        if dmp is None:
            if sig == self._full_sig and not self._kernels:
                dmp = self._dmp
            else:
                caps = dict(self._dmp.feature_caps)
                caps.update(zip(self._keys, sig))
                dmp = self._dmp.with_feature_caps(
                    caps, lookup_kernel=self._kernels.get("pooled"),
                    update_kernel=self._kernels.get("update"))
            self._entries[sig] = dmp
            self.stats.record_program()
        return dmp.train_step


def _bucketize_locals(
    cache: BucketedStepCache, locals_: List[Batch]
) -> Tuple[List[Batch], Tuple[int, ...]]:
    """The joint capacity signature of one step's local batches (per key,
    the largest occupancy, rounded up the ladder and bounded by the
    cache's admission rule), the batches repacked to it, and the padding
    counters of the group."""
    kjt0 = locals_[0].sparse_features
    keys = kjt0.keys()
    occs = [b.sparse_features.occupancy_per_key() for b in locals_]
    joint = tuple(max(o[f] for o in occs) for f in range(len(keys)))
    sig = cache.resolve(keys, cache.signature(keys, joint))
    n = len(locals_)
    cache.stats.record_batch(
        [sum(o[f] for o in occs) for f in range(len(keys))],
        [n * c for c in sig],
        [n * c for c in kjt0.caps],
    )
    repacked = [
        dataclasses.replace(b, sparse_features=b.sparse_features.repad(sig))
        for b in locals_
    ]
    return repacked, sig


class BucketedTrainPipeline(TrainPipelineSparseDist):
    """Adaptive-capacity train pipeline: the sparse-dist pipeline with a
    repack to the batch's bucketed signature on the host and a train step
    per signature (:class:`BucketedStepCache`).  Queue entries are
    ``(device batch, signature)``.  Left out besides the module's list:
    sharing one cache between pipelines (``cache=``)."""

    def __init__(
        self,
        dmp,
        state,
        bucketing: Optional[BucketingConfig] = None,
    ):
        super().__init__(step_fn=None, state=state, device=dmp.device)
        self._cache = BucketedStepCache(dmp, bucketing)

    @property
    def stats(self) -> PaddingStats:
        """The padding counters (``PaddingStats.scalar_metrics`` reads
        them)."""
        return self._cache.stats

    def scalar_metrics(self, prefix: str = "bucketing") -> Dict[str, float]:
        """The padding counters and the last step's ``id_overflow`` (the
        saturation guard: a shrunken capacity must never drop an id
        unobserved)."""
        out = self._cache.stats.scalar_metrics(prefix)
        out.update(TrainPipelineBase.scalar_metrics(self, prefix))
        return out

    def _queue_item(self, it: Iterator[Batch]):
        locals_ = self._pull_locals_async(it)
        if locals_ is None:
            return None
        with span("pipeline/bucketize"):
            locals_, sig = _bucketize_locals(self._cache, locals_)
        return self._stack_and_put(locals_), sig

    def progress(self, it: Iterator[Batch]):
        """One bucketed step; returns its metrics."""
        self._fill(it)
        if not self._queue:
            raise StopIteration
        batch, sig = self._queue.popleft()
        self._cache.stats.record_dispatch(sig)
        step = self._cache.train_program(sig)
        with span("pipeline/step_dispatch", signature=list(sig)):
            self.state, metrics = step(self.state, batch)
        self._last_metrics = metrics
        self._fill(it)
        return metrics
