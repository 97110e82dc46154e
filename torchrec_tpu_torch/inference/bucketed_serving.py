"""Bucketed serving programs, request dedup and the hot-row cache
(``torchrec_tpu/inference/bucketed_serving.py``).

The base ``InferenceServer`` runs every formed batch at the full
``max_batch`` shapes, so a 3-request batch pays the lookups, the dense
layers and the host-to-card copies of a 64-request one.  Here:

* **Bucketed serving programs** — a bounded family of programs keyed by
  ``(batch-size rung, per-feature id-capacity rung)`` from the geometric
  ``bucket_ladder``.  A formed batch dispatches to the smallest
  dominating signature; once ``max_programs`` is reached, new signatures
  round UP to an admitted dominating signature (or the reserved
  full-capacity one).  Padding contributes exactly +0.0 under SUM
  pooling, so the pooled embeddings are bitwise those of the full-pad
  program.  A program is the serving module bound to one signature's
  padded shapes; ``warmup`` runs it once at those shapes.  It runs
  eagerly (no capture per signature), so a program holds no state: the
  cache keeps the signatures run, for the program bound and counters.

* **Request dedup** — ``dedup=True`` (or ``"xla_dedup"`` /
  ``"pallas_dedup"``, the JAX package's kernel kinds) serves through the
  port's dedup lookup kernels (B5 for int8/int4/int2 tables, B4 for
  FP16/BF16 and float32), so an id repeated across coalesced requests is
  deduplicated before its row is read.  The kernel is picked per program
  through the serving callable's ``with_lookup_kernel`` (a
  ``ServingModule``'s shares its tables): there is no process-wide kernel
  switch.  The dedup kernels are bitwise the full-pad ones.

* **Hot-row serving cache** (:class:`HotRowServingCache`): a card-resident
  hot-row tier for tiered tables, on the tiered storage's remap core
  (``tiered/storage.py::TieredTable.remap``, ``lfu_aged`` by default).  On
  each formed batch the hot ids resolve to resident slots with no host
  traffic; misses read weight rows from the host tier and are written
  into the cache before dispatch.  The serving callable then takes the
  cache tensors as a third argument.  The JAX arrays are immutable, so a
  batch's snapshot taken inside the remap lock cannot change under it; a
  torch tensor can, so the port keeps that contract by copy-on-write: a
  fill or a refresh writes into a fresh copy of the table's cache
  (``Tensor.index_copy``, out of place) and swaps it in under the lock.
  A batch in flight keeps reading the tensor it took, and the caching
  allocator does not reuse its memory before the work queued on it (one
  stream) has run.  The cost is one copy of each filled table's cache a
  batch.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.inference.serving import (
    _BATCH_SIZE_BUCKETS,
    InferenceServer,
)
from torchrec_tpu_torch.obs.registry import MetricsRegistry
from torchrec_tpu_torch.obs.spans import span
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, bucketed_cap
from torchrec_tpu_torch.tiered.storage import TieredTable
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device
from torchrec_tpu_torch.utils.profiling import TieredStats

__all__ = [
    "ServingBucketConfig",
    "BucketedServingCache",
    "HotRowServingCache",
    "BucketedInferenceServer",
]

# the JAX package's dedup kernel kinds; each maps to the port's dedup
# lookup kernels
DEDUP_KINDS = ("xla_dedup", "pallas_dedup")

Signature = Tuple[int, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class ServingBucketConfig:
    """Serving-side capacity-bucketing policy.

    ``batch_floor``/``batch_growth`` ladder the BATCH-SIZE axis;
    ``id_floor``/``id_growth`` ladder each feature's TOTAL id capacity
    within the chosen batch rung.  ``max_programs`` bounds the distinct
    programs: the full-capacity signature owns a reserved slot, and
    beyond the bound new signatures round UP to an admitted dominating
    signature."""

    batch_floor: int = 1
    batch_growth: float = 2.0
    id_floor: int = 8
    id_growth: float = 2.0
    max_programs: int = 16

    @staticmethod
    def full_pad() -> "ServingBucketConfig":
        """The degenerate single-rung policy: every batch rounds up to
        ``max_batch`` and full per-feature capacity (the full-pad
        program, in the same machinery)."""
        return ServingBucketConfig(
            batch_floor=1 << 30, id_floor=1 << 30, max_programs=1
        )


def _dedup_kernel(dedup) -> Optional[str]:
    """The JAX ``dedup`` argument (a bool or a dedup kernel kind) as the
    port's lookup kernel: ``"dedup"``, or None (the serving module's
    own)."""
    if isinstance(dedup, str):
        if dedup not in DEDUP_KINDS:
            raise ValueError(
                f"dedup={dedup!r} is not a dedup kernel kind (expected "
                f"one of {DEDUP_KINDS}, or a bool)")
        return "dedup"
    return "dedup" if dedup else None


class BucketedServingCache:
    """Shape-keyed serving-program cache.

    Keys are signatures ``(batch_rung, (idcap_f0, idcap_f1, ...))``: the
    formed batch's request count rounded up the batch ladder, and each
    feature's observed total id count rounded up the id ladder (clipped
    to ``per_request_cap * batch_rung``).  ``resolve`` is the admission
    control: the full-capacity signature is always servable, at most
    ``config.max_programs - 1`` bucketed signatures are admitted, and
    everything else rounds up to the smallest admitted dominating
    signature (falling back to full capacity).  Thread-safe."""

    def __init__(  # graft-check: disable=ctor-too-wide
        self,
        serving_fn: Callable,
        feature_names: Sequence[str],
        feature_caps: Sequence[int],
        num_dense: int,
        max_batch: int,
        config: Optional[ServingBucketConfig] = None,
        dedup=False,  # bool, or a dedup kernel kind str
        extra_example=None,
        metrics: Optional[MetricsRegistry] = None,
        dedup_opts: Optional[Mapping[str, object]] = None,
    ):
        """``serving_fn(dense [Br, num_dense], kjt) -> scores [Br]``, or
        ``(dense, kjt, extra)`` when ``extra_example`` is given (the
        hot-row cache's tensors: a dict of tensors whose shapes and dtypes
        the warm-up's zero inputs take, e.g. ``HotRowServingCache.
        cache_specs()``).  ``dedup`` takes the callable's
        ``with_lookup_kernel`` view (a ``ServingModule``'s, or any
        callable's that has one).
        ``feature_caps`` are PER-REQUEST id capacities, ``max_batch`` the
        queue's forming bound.  ``dedup_opts`` (the Pallas kernels' tiling
        knobs) have no counterpart in the port and raise when given."""
        if dedup_opts:
            raise ValueError(
                f"dedup_opts {sorted(dedup_opts)} have no counterpart in "
                "the port: they tile the JAX package's Pallas kernels, and "
                "the CUDA dedup kernels take no such knobs")
        self.keys = tuple(feature_names)
        self.caps = [int(c) for c in feature_caps]
        self.num_dense = int(num_dense)
        self.max_batch = int(max_batch)
        self.config = config or ServingBucketConfig()
        kernel = _dedup_kernel(dedup)
        self.dedup = kernel is not None
        self.dedup_kernel = dedup if isinstance(dedup, str) else (
            "xla_dedup" if self.dedup else None)
        if kernel is not None:
            if not hasattr(serving_fn, "with_lookup_kernel"):
                raise TypeError(
                    "dedup serving needs a serving module with "
                    "with_lookup_kernel (inference.modules.ServingModule)")
            serving_fn = serving_fn.with_lookup_kernel(kernel)
        self._fn = serving_fn
        self._extra = extra_example
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._full_sig: Signature = (
            self.max_batch,
            tuple(c * self.max_batch for c in self.caps),
        )
        self._admitted: set = set()
        # the signatures run so far: the programs (eager, so a program
        # holds no state beyond its padded shapes)
        self._programs: set = set()
        self._lock = threading.Lock()

    @property
    def full_signature(self) -> Signature:
        """The reserved escape-hatch signature (max batch, full caps)."""
        return self._full_sig

    @property
    def program_count(self) -> int:
        """Number of distinct serving programs (bounded by
        ``config.max_programs``)."""
        with self._lock:
            return len(self._programs)

    def signature(self, n: int, occupancy: Sequence[int]) -> Signature:
        """Round a formed batch's request count and per-feature id
        occupancy up their ladders to the smallest covering signature."""
        cfg = self.config
        br = bucketed_cap(
            n, self.max_batch, cfg.batch_floor, cfg.batch_growth
        )
        idcaps = tuple(
            bucketed_cap(int(occ), cap * br, cfg.id_floor, cfg.id_growth)
            for occ, cap in zip(occupancy, self.caps)
        )
        return (br, idcaps)

    def resolve(self, sig: Signature) -> Signature:
        """Admit a signature or round it up to an admitted dominating one
        (the program-count bound; see the class docstring)."""
        with self._lock:
            if sig == self._full_sig or sig in self._admitted:
                return sig
            if len(self._admitted) < self.config.max_programs - 1:
                self._admitted.add(sig)
                return sig
            dominating = [
                s
                for s in self._admitted
                if s[0] >= sig[0]
                and all(a >= b for a, b in zip(s[1], sig[1]))
            ]
        self.metrics.counter("serving/program_fallback_count")
        if dominating:
            return min(dominating, key=lambda s: s[0] + sum(s[1]))
        return self._full_sig

    @property
    def fn(self) -> Callable:
        """The serving module every program runs (the dedup kernels' view
        when ``dedup``)."""
        return self._fn

    def run(self, sig: Signature, dense: torch.Tensor,
            kjt: KeyedJaggedTensor, extra=None) -> torch.Tensor:
        """Run the program of an admitted signature: the serving module on
        inputs padded to ``sig``'s shapes (and the trailing ``extra``).  A
        signature's first run counts a program
        (``serving/program_compile_count`` and the ``serving/
        program_count`` gauge, the JAX package's counters)."""
        br, caps = sig
        if dense.shape[0] != br or kjt.caps != caps:
            raise ValueError(f"program {sig} called with batch "
                             f"{dense.shape[0]} and caps {kjt.caps}")
        with self._lock:
            if sig not in self._programs:
                self._programs.add(sig)
                self.metrics.counter("serving/program_compile_count")
                self.metrics.gauge("serving/program_count",
                                   float(len(self._programs)))
        if extra is None:
            return self._fn(dense, kjt)
        return self._fn(dense, kjt, extra)

    def example_inputs(self, sig: Signature):
        """Zero inputs at a signature's shapes on the serving device:
        (dense [batch_rung, num_dense], an empty KJT with the signature's
        capacities), and zero tensors of ``extra_example``'s shapes when
        it was given."""
        br, idcaps = sig
        dev = torch.device(self._fn.device)
        kjt = KeyedJaggedTensor.from_lengths_packed(
            self.keys,
            np.zeros((0,), np.int64),
            np.zeros((len(self.keys) * br,), np.int32),
            caps=list(idcaps),
        )
        dense = torch.zeros((br, self.num_dense), dtype=torch.float32,
                            device=dev)
        if self._extra is None:
            return dense, kjt.to(dev)
        extra = {k: torch.zeros(tuple(v.shape), dtype=v.dtype, device=dev)
                 for k, v in self._extra.items()}
        return dense, kjt.to(dev), extra

    def warmup(self, signatures: Sequence[Signature] = ()) -> None:
        """Run the reserved full-capacity program plus any given
        signatures once on zero inputs (the kernels' first launch, the
        library handles), so first requests pay neither on the serving
        path.  ``signatures`` are admitted through ``resolve`` (they count
        against the program bound)."""
        sigs = [self._full_sig] + [
            self.resolve((sig[0], tuple(sig[1]))) for sig in signatures]
        for sig in sigs:
            self.run(sig, *self.example_inputs(sig))


class HotRowServingCache:
    """Card-resident hot-row tier for serving tiered tables (read-only).

    Each served table keeps ``cache_rows`` slots of float32 rows on the
    card; the host-side id -> slot remap is the training tier's
    (``TieredTable.remap``, DistanceLFU ``lfu_aged`` by default), with
    the hit / insert / eviction counters under ``<prefix>/<table>/
    <counter>``.  Misses read weight rows from the host tier (the
    authoritative copy: serving never writes back, so an eviction just
    drops).  The cache must hold one formed batch's distinct ids (the
    remap core raises otherwise).  Thread-safe: the remap, the fills and
    the snapshot run under one lock, and the caches are copy-on-write
    (module docstring).

    ``tables`` maps a table name to its :class:`TieredTable` (whose host
    tier holds every logical row); ``feature_to_table`` routes each hot
    feature to its table (other features pass through unremapped);
    ``device``: the card unless the caller names another."""

    def __init__(
        self,
        tables: Dict[str, TieredTable],
        feature_to_table: Mapping[str, str],
        stats: Optional[TieredStats] = None,
        device: DeviceLike = None,
    ):
        self.tables = dict(tables)
        self.feature_to_table = dict(feature_to_table)
        self.stats = stats if stats is not None else TieredStats()
        self.device = resolve_device(device)
        for tname, tbl in self.tables.items():
            # the exported occupancy_rate is normalized by the slots
            self.stats.record_capacity(tname, tbl.cache_rows)
        self._lock = threading.Lock()
        self._device: Dict[str, torch.Tensor] = {
            t: torch.zeros((tbl.cache_rows, tbl.embedding_dim),
                           dtype=torch.float32, device=self.device)
            for t, tbl in self.tables.items()}

    @classmethod
    def from_host_weights(
        cls,
        weights: Mapping[str, np.ndarray],
        cache_rows: Mapping[str, int],
        feature_to_table: Mapping[str, str],
        eviction_policy: str = "lfu_aged",
        device: DeviceLike = None,
    ) -> "HotRowServingCache":
        """Caches over host-RAM tiers initialized from full table weights
        (``[R, D]`` arrays): ``cache_rows[t]`` slots on the card each."""
        tables = {}
        for tname, w in weights.items():
            w = np.asarray(w, np.float32)
            tables[tname] = TieredTable(
                tname, w.shape[0], w.shape[1], int(cache_rows[tname]),
                opt_slots={}, eviction_policy=eviction_policy,
                init_fn=lambda s, e, w=w: w[s:e])
        return cls(tables, feature_to_table, device=device)

    def device_caches(self) -> Dict[str, torch.Tensor]:
        """The per-table cache tensors: the serving program's trailing
        argument (values change per batch, shapes never)."""
        with self._lock:
            return dict(self._device)

    def cache_specs(self) -> Dict[str, torch.Tensor]:
        """The caches' shapes and dtypes, as tensors on the meta device
        (what a program cache's ``extra_example`` takes, without pinning
        the first buffers)."""
        return {t: torch.empty(a.shape, dtype=a.dtype, device="meta")
                for t, a in self._device.items()}

    def remap(self, ids: np.ndarray, lengths: np.ndarray,
              features: Sequence[str]) -> np.ndarray:
        """The slots of :meth:`process` alone."""
        return self.process(ids, lengths, features)[0]

    def process(self, ids: np.ndarray, lengths: np.ndarray,
                features: Sequence[str]):
        """Remap a formed batch's hot-table ids to cache slots, fetch the
        missed rows into the caches, and return ``(slot_ids,
        cache_snapshot)``.

        ``ids`` is the request-major flat id buffer, ``lengths`` the
        ``[n, F]`` per-request per-feature counts, ``features`` the wire
        feature order.  Ids of features routed to no hot table pass
        through.  Ids must be in range already (raises otherwise: a corrupt
        id never claims a slot; sanitize upstream with
        ``degrade_on_bad_input``).  The snapshot is taken inside the lock;
        a later fill writes a fresh tensor, so what this batch reads cannot
        change under it."""
        lengths = np.asarray(lengths, np.int64)
        n, F = lengths.shape
        seg_of = np.repeat(np.arange(n * F), lengths.reshape(-1))
        f_of = seg_of % F
        out = np.array(ids[:len(f_of)], np.int64)
        with self._lock:
            for tname, tbl in self.tables.items():
                feat_idx = [i for i, f in enumerate(features)
                            if self.feature_to_table.get(f) == tname]
                if not feat_idx:
                    continue
                mask = np.isin(f_of, feat_idx)
                raw = out[mask]
                if raw.size == 0:
                    continue
                bad = (raw < 0) | (raw >= tbl.num_embeddings)
                if bad.any():
                    raise ValueError(
                        f"hot-row table {tname}: {int(bad.sum())} ids out "
                        "of range reached the serving cache remap: "
                        "sanitize upstream (degrade_on_bad_input)")
                slots, io, (hits, inserts, evs) = tbl.remap(raw)
                self.stats.record_remap(tname, len(raw), hits, inserts, evs,
                                        tbl.occupancy)
                if len(io.fetch_slots):
                    self._write_slots(tname, io.fetch_slots,
                                      tbl.read_weight_rows(io.fetch_logical))
                out[mask] = slots
            self.stats.record_batch()
            return out, dict(self._device)

    def _write_slots(self, tname: str, slots: np.ndarray, rows: np.ndarray,
                     refresh: bool = False) -> None:
        """Write host rows into their cache slots: a fresh copy of the
        cache with the rows in (out-of-place ``index_copy``), swapped in.
        ``refresh`` books them as in-place refreshes (a delta publish),
        not as fetch traffic."""
        cache = self._device[tname]
        idx = torch.as_tensor(np.asarray(slots, np.int64)).to(cache.device)
        vals = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(
            cache.device)
        self._device[tname] = cache.index_copy(0, idx, vals)
        k = len(slots)
        if refresh:
            self.stats.record_refresh(tname, k)
        else:
            self.stats.record_io(tname, fetched=k, written_back=0, sync=k)

    def refresh_rows(self, table: str, logical_ids: np.ndarray) -> int:
        """Re-read the given logical rows from the host tier into their
        RESIDENT cache slots (ids not resident are left: they fetch fresh
        on their next use): the delta stream's hook
        (``inference/freshness.py``) after it wrote the host tier.  Under
        the remap lock, so a batch reads either the snapshot it took or the
        refreshed caches.  Returns the number of slots refreshed."""
        tbl = self.tables[table]
        ids = np.ascontiguousarray(logical_ids, np.int64).reshape(-1)
        with self._lock:
            res_ids, res_slots = tbl.resident_items()
            mask = np.isin(res_ids, ids)
            if not mask.any():
                return 0
            logical, slots = res_ids[mask], res_slots[mask]
            self._write_slots(table, slots, tbl.read_weight_rows(logical),
                              refresh=True)
            return int(mask.sum())

    def scalar_metrics(self, prefix: str = "serving_cache"):
        """Flat per-table hit / miss / eviction counters under
        ``<prefix>/<table>/<counter>``."""
        return self.stats.scalar_metrics(prefix)


class BucketedInferenceServer(InferenceServer):
    """``InferenceServer`` dispatching formed batches to bucketed serving
    programs instead of the single full-pad program, with request dedup
    (the default, as in the JAX package).

    A formed batch of ``n`` requests with per-feature id occupancy
    ``occ`` runs the program for the smallest admitted ``(batch rung >=
    n, id rungs >= occ)`` signature; the pooled embeddings are bitwise
    the full-pad path's.  Per-batch serving metrics (program count,
    dispatch/fallback counters) land in ``self.metrics`` and the HTTP
    front end's ``/metrics`` endpoint; with ``hot_rows`` the hot-row
    counters too, absorbed every 16 batches (and at ``stop``)."""

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
        bucket_config: Optional[ServingBucketConfig] = None,
        dedup=True,  # bool, or a dedup kernel kind str
        hot_rows: Optional[HotRowServingCache] = None,
        dedup_opts: Optional[Mapping[str, object]] = None,
    ):
        """Base-server arguments exactly as in :class:`InferenceServer`;
        on top, ``bucket_config`` shapes the program ladder, ``dedup``
        serves through the dedup lookup kernels, and ``hot_rows`` routes
        tiered features through a :class:`HotRowServingCache` (the serving
        callable then takes the cache dict as a third argument)."""
        super().__init__(
            serving_fn,
            feature_names,
            feature_caps,
            num_dense,
            max_batch_size=max_batch_size,
            max_latency_us=max_latency_us,
            feature_rows=feature_rows,
            degrade_on_bad_input=degrade_on_bad_input,
            metrics=metrics,
            queue=queue,
        )
        self._hot = hot_rows
        # the hot-row counters reach the registry every N batches: the
        # per-table dict and the registry's lock are critical-path work
        self._hot_absorb_every = 16
        self._hot_batches = 0
        self.cache = BucketedServingCache(
            serving_fn,
            self.features,
            self.caps,
            num_dense,
            self.max_batch,
            config=bucket_config,
            dedup=dedup,
            extra_example=(hot_rows.cache_specs() if hot_rows is not None
                           else None),
            metrics=self.metrics,
            dedup_opts=dedup_opts,
        )

    def warmup(self, signatures=()) -> None:
        """Build the full-capacity program (+ optional extra signatures)
        before taking traffic."""
        self.cache.warmup(signatures)

    def stop(self) -> None:
        """Drain the executors, then absorb the hot-row counters the
        every-16-batches cadence may still hold back."""
        super().stop()
        if self._hot is not None:
            self.metrics.absorb(self._hot.scalar_metrics())

    def _run_batch(self, n, dense, ids, lengths):
        """Sanitize, remap the hot-row features, and dispatch the formed
        batch to the smallest dominating bucketed program; returns (scores
        [n], {request index -> degradation reason})."""
        self.metrics.observe(
            "serving/batch_size", float(n), buckets=_BATCH_SIZE_BUCKETS
        )
        dense, ids, lengths, reasons = self._sanitize_requests(
            n, dense, ids, lengths
        )
        caches = None
        if self._hot is not None:
            with span("serving/hot_row_remap", n=n):
                # the snapshot leaves the remap lock with the slots, so a
                # concurrent executor's fill cannot change this batch's
                ids, caches = self._hot.process(
                    ids, np.asarray(lengths[:n]), self.features)
            self._hot_batches += 1
            if self._hot_batches % self._hot_absorb_every == 1:
                self.metrics.absorb(self._hot.scalar_metrics())
        occ = np.asarray(lengths[:n], np.int64).sum(axis=0)
        sig = self.cache.resolve(self.cache.signature(n, occ))
        br, idcaps = sig
        args = self._device_inputs(n, dense, ids, lengths, br, list(idcaps))
        if caches is not None:
            args = args + (caches,)
        self.metrics.counter("serving/bucketed_dispatch_count")
        with span("serving/run_batch", n=n, batch_rung=br):
            scores = self.cache.run(sig, *args).float().cpu().numpy()
        return scores[:n], reasons
