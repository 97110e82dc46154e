"""Train pipelines (a subset of ``torchrec_tpu/parallel/train_pipeline.py``),
one process a rank.

``TrainPipelineBase`` keeps a queue of batches already on the device
(``depth + 1`` deep) filled from a background :class:`DataLoadingThread`,
so batch construction on the host overlaps the step before it;
``TrainPipelineSparseDist`` keeps it deeper.  Both may carry a
:class:`~torchrec_tpu_torch.utils.profiling.KernelStats` ledger
(``attach_kernel_stats``) and a touched-row ledger
(``attach_touched_rows``: anything with ``record(table, ids)``, credited
when the batch's step dispatches); ``scalar_metrics`` gives the last
step's guardrail counters (``id_overflow``, ``dedup_overflow``,
``id_violations`` in all and per key).

The split pipelines run ``DistributedModelParallel``'s two halves:
``TrainPipelineSemiSync`` embeds batch ``i + 1`` against the tables as
they were before step ``i``'s update.  The port's fused updates write
the tables in place, so the pipeline embeds batch ``i + 1`` before it
runs step ``i``'s dense half and update (the JAX package keeps the old
table arrays instead): on one stream the same arithmetic, with no copy
of a table.  ``invalidate_prefetch`` recomputes the pending embedding on
the current tables after the state is replaced.
``PrefetchTrainPipelineSparseDist`` adds a host ``preprocess`` hook
whose aux ``apply_aux`` hands to the state before the batch's step;
``StagedTrainPipeline`` chains host stages; ``EvalPipelineSparseDist``
runs a forward-only ``eval_fn`` (e.g. on ``make_forward``) over the same
queue and leaves the state alone.

``BucketedTrainPipeline`` adds capacity bucketing: each batch's per-key
occupancy rounds up a geometric ladder
(``sparse/jagged_tensor.py::bucket_ladder``), the batch is repacked to
that capacity signature on the host, and a :class:`BucketedStepCache`
runs it through the step of that signature's
``DistributedModelParallel.with_feature_caps`` clone.  Every clone shares
the one train state; rungs never fall below occupancy, so a bucketed step
gives the same numbers as the full-capacity step.  At more than one rank
the ranks agree on each signature (an all-gather of the occupancy and the
dedup demand, the maximum over ranks), or their collectives would not
match.  A dedup'd row-wise group whose ``dedup_factor`` shrinks its
distinct-id capacity is guarded (``_dedup_overflow_guard``): a batch
whose distinct ids would overflow its signature's capacity runs the
full-capacity step, and ``PaddingStats.overflow_fallback_count`` counts
it.  ``BucketedTrainPipelineSemiSync`` is the semi-sync pipeline over the
signatures' halves.

The port compiles nothing: a signature's "program" is its clone's eager
step, built on first use or by ``BucketedTrainPipeline.warmup`` (the JAX
package AOT-compiles one XLA program per signature).
``BucketingConfig.kernels`` names the clones' kernels, ``{"pooled":
"tbe"|"dedup", "update": "tbe"|"dedup"}``, where the JAX package selects
them process-wide around each compile.

The bucketed pipelines carry a host hook pair: ``_preprocess_locals``
runs on a step's local batches when they are queued (while the step
before runs) and returns an aux that rides the queue entry;
``_apply_aux`` hands it to the live state right before the entry's step
(the semi-sync pipeline refuses an aux).  Both are no-ops here;
``tiered/pipeline.py`` overrides them with the cache's remap and IO.

Left out: the multi-device grouping of one process (one local batch a
step here), buffer donation and the hierarchical parts of the overflow
guard (ROADMAP A8).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
from typing import (
    Any, Callable, Deque, Dict, Iterator, List, Mapping, Optional,
    Sequence, Tuple,
)

import numpy as np
import torch

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.obs.spans import span
from torchrec_tpu_torch.parallel.comm import (
    add_to_ledger,
    all_gather,
    wire_accounting,
)
from torchrec_tpu_torch.parallel.model_parallel import stack_batches
from torchrec_tpu_torch.parallel.sharding.hier import hier_cap_for
from torchrec_tpu_torch.parallel.sharding.rw import dedup_cap_for
from torchrec_tpu_torch.sparse.jagged_tensor import (
    KeyedJaggedTensor,
    bucketed_cap,
)
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device
from torchrec_tpu_torch.utils.profiling import PaddingStats, counter_key


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


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t))


def _valid_ids_per_key(kjt: KeyedJaggedTensor) -> Dict[str, np.ndarray]:
    """Each key's real ids (the front-packed prefix of its region), on the
    host."""
    lens, values = _host(kjt.lengths()), _host(kjt.values())
    lo, co = kjt._length_offsets(), kjt.cap_offsets()
    return {k: values[co[i]:co[i] + int(lens[lo[i]:lo[i + 1]].sum())]
            for i, k in enumerate(kjt.keys())}


class TrainPipelineBase:
    """Pipelined train loop: while step ``i`` runs, batch ``i + 1`` is
    built on a background thread and copied to the device.  ``step_fn``
    is ``(state, batch) -> (state, metrics)`` (e.g. ``dmp.train_step``);
    the live state is ``self.state``."""

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
        self._last_keys: Optional[Tuple[str, ...]] = None
        self._kernel_stats = None
        self._kernel_feature_info: Dict[str, Tuple[str, int]] = {}
        # the touched-row ledger's entries wait here, one a queued batch,
        # until that batch's step dispatches
        self._touched_rows = None
        self._pending_touched: Deque[Dict[str, np.ndarray]] = (
            collections.deque())

    def _pull_locals_async(self, it: Iterator[Batch]) -> Optional[List[Batch]]:
        """The step's local batches (one a process) from the background
        loader; None at the end of the source."""
        if self._loader is None or self._loader_it is not it:
            if self._loader is not None:
                self._loader.stop()
            self._loader = DataLoadingThread(it, prefetch=self.depth + 1)
            self._loader_it = it
        # the batch pull's cost to this thread: the time it blocked on the
        # loader (the data-load overlap of ``obs report``)
        with span("pipeline/host_load", n=1):
            ok, item = self._loader._get()
        return [item] if ok else None

    def attach_kernel_stats(
        self, stats,
        feature_info: Optional[Dict[str, Tuple[str, int]]] = None,
    ) -> None:
        """Count each queued batch's per-id and distinct rows per table
        into ``stats`` (``utils.profiling.KernelStats``).  ``feature_info``
        maps a feature to (its table, its row bytes), e.g.
        ``GroupedShardingBase.feature_table_info()``; without it a feature
        counts as its own table at 0 bytes.  A host ``np.unique`` a key a
        batch."""
        self._kernel_stats = stats
        self._kernel_feature_info = dict(feature_info or {})

    def attach_touched_rows(
        self, tracker,
        feature_info: Optional[Dict[str, Tuple[str, int]]] = None,
    ) -> None:
        """Credit each table's valid ids to ``tracker.record(table, ids)``
        when the batch's step dispatches (the scan runs when the batch is
        queued, the credit waits for its step, so a drain between them
        never sees rows still holding their pre-step weights)."""
        self._touched_rows = tracker
        if feature_info:
            self._kernel_feature_info.update(feature_info)

    def _record_host_ledgers(self, locals_: List[Batch]) -> None:
        """One pass over the local batches' valid ids per key, feeding the
        attached ledgers."""
        if self._kernel_stats is None and self._touched_rows is None:
            return
        per_key: Dict[str, List[np.ndarray]] = {}
        for b in locals_:
            for key, ids in _valid_ids_per_key(b.sparse_features).items():
                per_key.setdefault(key, []).append(ids)
        pending: Dict[str, List[np.ndarray]] = {}
        for key, chunks in per_key.items():
            table, row_bytes = self._kernel_feature_info.get(key, (key, 0))
            valid = np.concatenate(chunks).reshape(-1)
            if self._kernel_stats is not None:
                self._kernel_stats.record_lookup(table, valid, row_bytes)
            if self._touched_rows is not None:
                pending.setdefault(table, []).append(valid)
        if self._kernel_stats is not None:
            self._kernel_stats.record_batch_done()
        if self._touched_rows is not None:
            self._pending_touched.append(
                {t: np.concatenate(c).reshape(-1) for t, c in pending.items()})

    def _stack_and_put(self, locals_: List[Batch]) -> Batch:
        with span("pipeline/h2d"):
            out = stack_batches(locals_).to(self.device)
        if self._kernel_stats is not None or self._touched_rows is not None:
            with span("pipeline/kernel_stats"):
                self._record_host_ledgers(locals_)
        return out

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
        self._record_step(batch, metrics)
        self._fill(it)
        return metrics

    def _record_step(self, batch: Batch, metrics) -> None:
        """Keep the step's metrics and keys, and credit the touched-row
        ledger with this batch's entry (the queue's oldest)."""
        self._last_metrics = metrics
        self._last_keys = batch.sparse_features.keys()
        if self._touched_rows is not None and self._pending_touched:
            for table, ids in self._pending_touched.popleft().items():
                self._touched_rows.record(table, ids)

    def scalar_metrics(self, prefix: str = "pipeline") -> Dict[str, float]:
        """The kernel-stats counters, and the last step's ``id_overflow``
        and ``dedup_overflow`` (summed over keys) and ``id_violations``
        (in all and per key), flat.  Reads the device's counts: call it
        at metric-collection cadence, not every step."""
        out: Dict[str, float] = {}
        if self._kernel_stats is not None:
            out.update(self._kernel_stats.scalar_metrics())
        m = self._last_metrics
        if not isinstance(m, dict):
            return out
        for name in ("id_overflow", "dedup_overflow"):
            if name in m:
                out[f"{prefix}/{name}"] = float(_host(m[name]).sum())
        if "id_violations" in m:
            v = _host(m["id_violations"]).reshape(-1)
            out[f"{prefix}/id_violations"] = float(v.sum())
            keys = self._last_keys or ()
            if len(keys) == v.shape[0]:
                for k, n in zip(keys, v):
                    out[counter_key(prefix, k, "id_violations")] = float(n)
        return out

    def invalidate_prefetch(self) -> None:
        """Recompute any prefetched work derived from the state, after the
        state was replaced (a rollback or a resume).  Queued batches do not
        depend on it; the split pipelines override."""


class StagedTrainPipeline:
    """A chain of host stages, each a callable item -> item with a queue
    of ``depth_per_stage``: stage ``k`` of item ``i`` runs after stage
    ``k + 1`` of item ``i - 1`` has taken its input (lookahead; the
    stages run eagerly on this thread, device work asynchronously)."""

    def __init__(self, stages: Sequence[Callable[[Any], Any]],
                 depth_per_stage: int = 1):
        self._stages = list(stages)
        self._queues: List[Deque[Any]] = [collections.deque()
                                          for _ in self._stages]
        self._depth = depth_per_stage
        self._exhausted = False

    def progress(self, it: Iterator[Any]):
        """The next item through every stage; ``StopIteration`` when the
        source and the queues are empty."""
        for si in range(len(self._stages)):
            src = self._queues[si - 1] if si else None
            while len(self._queues[si]) < self._depth:
                if si == 0:
                    if self._exhausted:
                        break
                    try:
                        item = next(it)
                    except StopIteration:
                        self._exhausted = True
                        break
                else:
                    if not src:
                        break
                    item = src.popleft()
                self._queues[si].append(self._stages[si](item))
        if not self._queues[-1]:
            raise StopIteration
        return self._queues[-1].popleft()


class TrainPipelineSemiSync(TrainPipelineBase):
    """The semi-synchronous pipeline over ``dmp``'s split step: batch
    ``i + 1``'s embedding (``dmp.embed_step``: input dist, lookup, output
    dist) reads the tables as they were before step ``i``'s update, and
    the gradients of step ``i`` (``dmp.dense_update_step``) apply to the
    current tables.  The port's updates are in place, so ``progress``
    embeds batch ``i + 1`` before it runs step ``i``'s dense half and
    update (module docstring).  A queue item runs through two hooks,
    ``_embed(item)`` and ``_dense(item, kt, ctxs)``; the bucketed
    subclass overrides only those."""

    def __init__(self, dmp, state):
        super().__init__(step_fn=None, state=state, device=dmp.device)
        self._dmp = dmp
        self._pending = None  # (queue item, (kt_values, ctxs))

    def _embed(self, batch: Batch):
        return self._dmp.embed_step(self.state["tables"], batch)

    def _dense(self, batch: Batch, kt, ctxs):
        """Step ``batch`` on its embedding; returns (batch, metrics)."""
        with span("pipeline/step_dispatch"):
            self.state, metrics = self._dmp.dense_update_step(
                self.state, batch, kt, ctxs)
        return batch, metrics

    def progress(self, it: Iterator[Batch]):
        """Step ``i`` on its pending embedding, after batch ``i + 1``'s
        embedding on the tables before it."""
        if self._pending is None and not self._exhausted:
            item = self._queue_item(it)
            if item is None:
                self._exhausted = True
            else:
                self._pending = (item, self._embed(item))
        if self._pending is None:
            raise StopIteration
        item, (kt, ctxs) = self._pending
        nxt = self._queue_item(it)
        if nxt is not None:
            nxt = (nxt, self._embed(nxt))
        batch, metrics = self._dense(item, kt, ctxs)
        self._record_step(batch, metrics)
        self._pending = nxt
        self._exhausted = nxt is None
        return metrics

    def invalidate_prefetch(self) -> None:
        """Recompute the pending embedding on the current tables: the one
        kept was read from tables that no longer exist."""
        if self._pending is not None:
            item = self._pending[0]
            self._pending = (item, self._embed(item))


class PrefetchTrainPipelineSparseDist(TrainPipelineBase):
    """The base pipeline with a host hook: ``preprocess(local batch) ->
    (local batch, aux)`` runs when the batch is queued, while the step
    before it runs; ``apply_aux(state, [aux]) -> state`` hands the auxes to
    the live state right before the batch's step.  Queue entries are
    (batch, auxes), so the two cannot part."""

    def __init__(
        self,
        step_fn: Callable[[Any, Batch], Any],
        state: Any,
        device: DeviceLike = None,
        preprocess: Optional[Callable[[Batch], Tuple[Batch, Any]]] = None,
        apply_aux: Optional[Callable[[Any, List[Any]], Any]] = None,
    ):
        super().__init__(step_fn, state, device)
        self._preprocess = preprocess
        self._apply_aux = apply_aux

    def _queue_item(self, it: Iterator[Batch]):
        locals_ = self._pull_locals_async(it)
        if locals_ is None:
            return None
        auxes: List[Any] = []
        if self._preprocess is not None:
            processed = []
            for b in locals_:
                b2, aux = self._preprocess(b)
                processed.append(b2)
                auxes.append(aux)
            locals_ = processed
        return self._stack_and_put(locals_), auxes

    def progress(self, it: Iterator[Batch]):
        self._fill(it)
        if not self._queue:
            raise StopIteration
        batch, auxes = self._queue.popleft()
        if self._apply_aux is not None:
            self.state = self._apply_aux(self.state, auxes)
        with span("pipeline/step_dispatch"):
            self.state, metrics = self._step(self.state, batch)
        self._record_step(batch, metrics)
        self._fill(it)  # queue and preprocess i + 1 while step i runs
        return metrics


class EvalPipelineSparseDist(TrainPipelineBase):
    """Forward-only evaluation over the sparse-dist pipeline's queue:
    ``eval_fn(state, batch) -> metrics`` (e.g. ``dmp.make_forward()``'s
    logits), the state never changed."""

    depth = 2

    def __init__(self, eval_fn: Callable[[Any, Batch], Any], state: Any,
                 device: DeviceLike = None):
        super().__init__(lambda s, b: (s, eval_fn(s, b)), state, device)


class TrainPipelineSparseDist(TrainPipelineBase):
    """The base pipeline with two batches in flight (the reference's
    three-stage sparse-dist pipeline; each rank's process feeds its own
    batch, so only the queue depth remains)."""

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
    """Signature-keyed steps over one live train state.  A signature is
    the per-feature bucketed capacities in the batch's key order; each
    owns a ``dmp.with_feature_caps`` clone, built on first use, whose
    ``train_step`` (:meth:`train_program`) and split halves
    (:meth:`embed_program`, :meth:`dense_program`) are its programs.
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
        # (signature, program kind) pairs whose ledger is recorded
        self._ledgered: set = set()

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

    @property
    def program_count(self) -> int:
        """Signatures whose clone exists."""
        return len(self._entries)

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

    def _clone(self, sig: Sequence[int]):
        """The signature's DMP clone, built (and counted) on first use."""
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
            self.stats.record_program(sig)
        return dmp

    @contextlib.contextmanager
    def accounting(self, sig: Sequence[int], kind: str):
        """Around a dispatch of a signature's program (``kind``: "train",
        "embed" or "dense"): the first of each runs under
        ``wire_accounting`` and its ledger goes to
        ``stats.record_compile`` (the bytes also reach an enclosing
        ledger); later ones run as they are."""
        key = (tuple(sig), kind)
        if key in self._ledgered:
            yield
            return
        with wire_accounting() as ledger:
            yield
        add_to_ledger(ledger)
        self._ledgered.add(key)
        self.stats.record_compile(sig, ledger)

    def train_program(self, sig: Sequence[int]):
        """The train step of a signature's clone."""
        return self._clone(sig).train_step

    def embed_program(self, sig: Sequence[int]):
        """The split step's first half of a signature's clone."""
        return self._clone(sig).embed_step

    def dense_program(self, sig: Sequence[int]):
        """The split step's second half of a signature's clone."""
        return self._clone(sig).dense_update_step


def _dedup_cap_for_caps(layout, caps_by_key: Mapping[str, int]) -> int:
    """A dedup'd row-wise layout's distinct-id capacity under other
    per-feature caps (``build_rw_layout``'s rule, no rebuild)."""
    return dedup_cap_for(layout.features, caps_by_key, layout.block_size,
                         layout.dedup_factor)


def _hier_cap_for_caps(layout, caps_by_key: Mapping[str, int]) -> int:
    """A two-level row-wise layout's distinct-row DCN capacity under other
    per-feature caps (``build_rw_layout``'s rule: the stage-1 send cap
    into ``hier_cap_for``, no rebuild)."""
    send_cap = (_dedup_cap_for_caps(layout, caps_by_key) if layout.dedup
                else max(caps_by_key[f.name] for f in layout.features))
    return hier_cap_for(layout.hier.ici_size, len(layout.features),
                        send_cap, layout.l_stack, layout.hier_factor)


def _hier_union_sizes(layout, locals_: List[Batch], first_index: int = 0,
                      sanitize: bool = False) -> np.ndarray:
    """``[num_slices, world]`` partial stage-2 demands of a two-level
    row-wise layout: entry ``[s, d]`` counts the distinct (feature,
    destination-local row) elements the local batches (global ranks from
    ``first_index``) send from slice ``s`` toward rank ``d``, the
    aggregator's slots for that pair.  Sizes, not sets, so that the
    ranks' partials can be all-gathered and summed: exact when one
    process holds a slice's batches, an upper bound when a slice spans
    processes (one process a rank here)."""
    L, S = layout.hier.ici_size, layout.hier.num_slices
    out = np.zeros((S, S * L), np.int64)
    unions: Dict[Tuple[int, int], set] = {}
    for j, b in enumerate(locals_):
        src = (first_index + j) // L
        real_by_key = _valid_ids_per_key(b.sparse_features)
        for fi, f in enumerate(layout.features):
            real = real_by_key[f.name]
            if sanitize:
                real = real[(real >= 0) & (real < f.table_rows)]
            if real.size == 0:
                continue
            bs = layout.block_size[f.table_name]
            r = np.clip(real.astype(np.int64), 0, f.table_rows - 1)
            dest = r // bs
            elem = fi * (1 << 32) + r % bs
            for d in np.unique(dest):
                unions.setdefault((src, int(d)), set()).update(
                    elem[dest == d].tolist())
    for (s_, d), u in unions.items():
        out[s_, d] = len(u)
    return out


def _dedup_demand(layout, locals_: List[Batch],
                  sanitize: bool = False) -> int:
    """The most distinct ids one (feature, destination) pair of
    ``layout`` gets from any of the local batches (host numpy).  With
    ``sanitize`` the ids the sanitizer would null do not count (they
    never reach the wire); other ids are clamped into the table first,
    so a corrupt id cannot blow up the destination arithmetic."""
    need = 0
    for b in locals_:
        real_by_key = _valid_ids_per_key(b.sparse_features)
        for f in layout.features:
            real = real_by_key[f.name]
            if sanitize:
                real = real[(real >= 0) & (real < f.table_rows)]
            if real.size == 0:
                continue
            bs = layout.block_size[f.table_name]
            r = np.clip(real.astype(np.int64), 0, f.table_rows - 1)
            pairs = np.unique((r // bs) * (1 << 32) + r % bs)
            counts = np.bincount((pairs >> 32).astype(np.int64), minlength=1)
            need = max(need, int(counts.max()))
    return need


def _guarded_layouts(cache: BucketedStepCache) -> List[Any]:
    """The dedup'd layouts whose factor shrinks their capacity below the
    exactness bound: the only ones a bucketed signature can overflow."""
    return [lay for lay in cache._dmp.sharded_ebc.rw_layouts.values()
            if lay.dedup and lay.dedup_factor > 1.0]


def _hier_guarded_layouts(cache: BucketedStepCache) -> List[Any]:
    """The two-level row-wise layouts whose ``hier_factor`` shrinks their
    DCN capacity below the exactness bound."""
    return [lay for lay in cache._dmp.sharded_ebc.rw_layouts.values()
            if lay.hier is not None and lay.hier_factor > 1.0]


def _dedup_overflow_guard(
    cache: BucketedStepCache,
    sig: Tuple[int, ...],
    demands: Mapping[str, int],
) -> Tuple[int, ...]:
    """The full-capacity signature when a guarded layout's distinct-id
    demand exceeds the capacity ``sig`` gives it (the downgrade counted in
    ``stats.overflow_fallback_count``), else ``sig``.  At factor 1 the
    capacity is the exactness bound and no demand passes it.
    ``demands``: guarded layout name -> its demand (``_dedup_demand``),
    the maximum over ranks, and ``"<name>#hier"`` -> a two-level layout's
    stage-2 demand (the largest entry of the ranks' summed
    ``_hier_union_sizes``) against its DCN capacity at ``sig``
    (``_hier_cap_for_caps``), so every rank decides alike."""
    layouts = cache._dmp.sharded_ebc.rw_layouts
    caps_by_key = dict(zip(cache._keys, sig))
    for name, demand in demands.items():
        hier = name.endswith("#hier")
        lay = layouts[name[:-len("#hier")] if hier else name]
        caps = {f.name: caps_by_key.get(f.name, f.cap) for f in lay.features}
        capacity = (_hier_cap_for_caps(lay, caps) if hier
                    else _dedup_cap_for_caps(lay, caps))
        if demand > capacity:
            cache.stats.record_overflow_fallback()
            return cache.full_signature
    return sig


def _bucketize_locals(
    cache: BucketedStepCache, locals_: List[Batch]
) -> Tuple[List[Batch], Tuple[int, ...]]:
    """The step's capacity signature (per key, the largest occupancy,
    rounded up the ladder, bounded by the cache's admission rule, then
    through the dedup overflow guard), the local batches repacked to it,
    and the padding counters.  At more than one rank the occupancy and
    the guarded layouts' demands are the maxima over every rank and the
    two-level layouts' partial union sizes the sums over every rank (one
    all-gather), so every rank runs the same signature."""
    kjt0 = locals_[0].sparse_features
    keys = kjt0.keys()
    occs = [b.sparse_features.occupancy_per_key() for b in locals_]
    joint = [max(o[f] for o in occs) for f in range(len(keys))]
    cache._bind_keys(keys)
    lays = _guarded_layouts(cache)
    hier_lays = _hier_guarded_layouts(cache)
    sanitize = bool(cache._dmp.sharded_ebc.sanitize)
    demands = [_dedup_demand(lay, locals_, sanitize) for lay in lays]
    env = cache._dmp.env
    unions = [_hier_union_sizes(lay, locals_, env.rank, sanitize)
              for lay in hier_lays]
    if env.world_size > 1:
        mine = torch.tensor(
            joint + demands + [int(x) for u in unions for x in u.reshape(-1)],
            dtype=torch.int64)
        every = all_gather(mine.to(env.device), env)
        n = len(keys) + len(demands)
        agreed = every[:, :n].amax(0).tolist()
        joint, demands = agreed[:len(keys)], agreed[len(keys):]
        # the union sizes are summed, not maxed: each rank's are its own
        # sources' share of a (slice, destination) pair's demand
        summed = every[:, n:].sum(0).cpu().numpy()
        sizes = [u.size for u in unions]
        unions = [p.reshape(u.shape) for p, u in zip(
            np.split(summed, np.cumsum(sizes)[:-1]), unions)]
    sig = cache.resolve(keys, cache.signature(keys, joint))
    named = {l.name: d for l, d in zip(lays, demands)}
    named.update({f"{l.name}#hier": int(u.max()) if u.size else 0
                  for l, u in zip(hier_lays, unions)})
    sig = _dedup_overflow_guard(cache, sig, named)
    n = len(locals_)
    cache.stats.record_batch(
        keys,
        [sum(o[f] for o in occs) for f in range(len(keys))],
        [n * c for c in sig],
        [n * c for c in kjt0.caps],
    )
    repacked = [
        dataclasses.replace(b, sparse_features=b.sparse_features.repad(sig))
        for b in locals_
    ]
    return repacked, sig


class _BucketedPipelineMixin:
    """The bucketed pipelines' queue entries ``(device batch, signature,
    aux)``, their host preprocessing hooks and counters."""

    _cache: BucketedStepCache

    def _preprocess_locals(self, locals_: List[Batch]
                           ) -> Tuple[List[Batch], Any]:
        """Hook: host preprocessing of a step's local batches before the
        bucketing (the tiered cache's remap, ``tiered/pipeline.py``).  It
        runs while the dispatched step executes; returns ``(locals_,
        aux)``, and the aux rides the queue entry to :meth:`_apply_aux`."""
        return locals_, None

    def _apply_aux(self, state, aux):
        """Hook: consume a queue entry's aux against the live state (the
        cache's write-backs and fills) before the entry's batch reads any
        table row."""
        return state

    def _queue_item(self, it: Iterator[Batch]):
        locals_ = self._pull_locals_async(it)
        if locals_ is None:
            return None
        locals_, aux = self._preprocess_locals(locals_)
        with span("pipeline/bucketize"):
            locals_, sig = _bucketize_locals(self._cache, locals_)
        return self._stack_and_put(locals_), sig, aux

    @property
    def stats(self) -> PaddingStats:
        """The padding counters (``PaddingStats.scalar_metrics`` reads
        them)."""
        return self._cache.stats

    @property
    def cache(self) -> BucketedStepCache:
        return self._cache

    def scalar_metrics(self, prefix: str = "bucketing") -> Dict[str, float]:
        """The padding counters and the last step's guardrail counters
        (:meth:`TrainPipelineBase.scalar_metrics`: a shrunken capacity
        must never drop an id unobserved)."""
        out = self._cache.stats.scalar_metrics(prefix)
        out.update(TrainPipelineBase.scalar_metrics(self, prefix))
        return out


class BucketedTrainPipeline(_BucketedPipelineMixin, TrainPipelineSparseDist):
    """Adaptive-capacity train pipeline: the sparse-dist pipeline with a
    repack to the batch's bucketed signature on the host and a train step
    per signature (:class:`BucketedStepCache`).  Left out besides the
    module's list: sharing one cache between pipelines (``cache=``)."""

    def __init__(
        self,
        dmp,
        state,
        bucketing: Optional[BucketingConfig] = None,
    ):
        super().__init__(step_fn=None, state=state, device=dmp.device)
        self._cache = BucketedStepCache(dmp, bucketing)

    def progress(self, it: Iterator[Batch]):
        """One bucketed step; returns its metrics."""
        self._fill(it)
        if not self._queue:
            raise StopIteration
        batch, sig, aux = self._queue.popleft()
        if aux is not None:
            self.state = self._apply_aux(self.state, aux)
        self._cache.stats.record_dispatch(sig)
        step = self._cache.train_program(sig)
        with span("pipeline/step_dispatch", signature=list(sig)), \
                self._cache.accounting(sig, "train"):
            self.state, metrics = step(self.state, batch)
        self._record_step(batch, metrics)
        self._fill(it)
        return metrics

    def warmup(self, example_local_batch: Batch, occupancies) -> None:
        """Build the step of each expected occupancy profile's signature
        (a dict by key, or a sequence in the batch's key order) without
        running a step: the state is not read.  Every rank passes the same
        profiles."""
        keys = example_local_batch.sparse_features.keys()
        for occ in occupancies:
            occ_t = (tuple(int(occ[k]) for k in keys)
                     if isinstance(occ, Mapping)
                     else tuple(int(x) for x in occ))
            self._cache.train_program(
                self._cache.resolve(keys, self._cache.signature(keys, occ_t)))


class BucketedTrainPipelineSemiSync(_BucketedPipelineMixin,
                                    TrainPipelineSemiSync):
    """:class:`TrainPipelineSemiSync` over the signatures' split halves:
    a queue item is ``(batch, signature)``, each batch embedded by its own
    signature's clone on the tables before the step ahead of it, so
    ``invalidate_prefetch`` recomputes the pending embedding on the
    current tables with the pending batch's own signature: a replay never
    meets stale tables or another signature's shapes."""

    def __init__(self, dmp, state,
                 bucketing: Optional[BucketingConfig] = None):
        super().__init__(dmp, state)
        self._cache = BucketedStepCache(dmp, bucketing)

    def _queue_item(self, it: Iterator[Batch]):
        item = super()._queue_item(it)
        if item is None:
            return None
        batch, sig, aux = item
        if aux is not None:
            # an aux's rows would land after the step ahead had embedded
            # against the tables before them
            raise TypeError("the semi-sync pipeline takes no aux")
        return batch, sig

    def _embed(self, item):
        batch, sig = item
        with self._cache.accounting(sig, "embed"):
            return self._cache.embed_program(sig)(self.state["tables"],
                                                  batch)

    def _dense(self, item, kt, ctxs):
        batch, sig = item
        self._cache.stats.record_dispatch(sig)
        dense = self._cache.dense_program(sig)
        with span("pipeline/step_dispatch", signature=list(sig)), \
                self._cache.accounting(sig, "dense"):
            self.state, metrics = dense(self.state, batch, kt, ctxs)
        return batch, metrics
