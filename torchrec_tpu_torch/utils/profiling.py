"""Tracing and host counters (a subset of
``torchrec_tpu/utils/profiling.py``): :class:`annotate` (a phase on the
profiler's timeline), :func:`method_logger`, the counter-key namespace,
the bucketing pipeline's padding counters (:class:`PaddingStats`), the
lookups' row-traffic ledger (:class:`KernelStats`), the tiered-storage
ledger (:class:`TieredStats`) and a JSONL event log (:class:`EventLog`).

Left out: ``trace`` (``torch.profiler.profile`` is its counterpart)."""

from __future__ import annotations

import functools
import json
import logging
import os
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# obs/spans.py imports nothing of the package but the flight recorder
from torchrec_tpu_torch.obs.spans import span as _obs_span

logger = logging.getLogger("torchrec_tpu_torch")


class annotate:
    """A named phase: a span (``obs/spans.py``), which is a range on the
    profiler's timeline (what the JAX package's ``jax.named_scope``
    marks) and a record of the installed ``SpanTracer`` when there is
    one; a context manager, or a decorator with :meth:`__call__`."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "annotate":
        # a fresh span each entry: a profiler range is single-use
        self._span = _obs_span(self.name)
        self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._span.__exit__(exc_type, exc, tb)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with annotate(self.name):
                return fn(*args, **kwargs)

        return wrapper


def method_logger(fn):
    """Log each call's wall time at DEBUG level (the reference's
    ``_torchrec_method_logger``)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            logger.debug("torchrec_tpu_torch.%s took %.3fms",
                         getattr(fn, "__qualname__", fn.__name__),
                         (time.perf_counter() - t0) * 1e3)

    return wrapper


def counter_key(prefix: str, table: str, counter: str) -> str:
    """THE per-table counter namespace: ``<prefix>/<table>/<counter>``."""
    return f"{prefix}/{table}/{counter}"


class PaddingStats:
    """Host-side padding counters of the capacity-bucketing pipeline
    (``parallel/train_pipeline.py``): per-key occupancy, id slots shipped
    under the bucketed and under the static capacities, dispatches per
    signature, the wire-byte ledger of each signature's programs, and
    round-up fallbacks.  ``scalar_metrics`` carries the JAX package's keys
    (the per-key means under ``<prefix>/<key>/*`` and the ledgers under
    ``wire/<tag>/bytes_per_step``, which ``obs report`` and the health
    monitor read) and the port's ``dispatch_count``.

    The port compiles nothing: a "compile" is a signature's program kind
    (the fused step, the semi-sync halves) dispatched for the first time,
    and its ledger the ``comm.wire_accounting()`` of that dispatch, the
    byte count the JAX package's trace-time ledger gives for the same
    shapes; ``record_program`` notes a signature's DMP clone built (at
    first use or by ``warmup``), which ``program_count`` counts.
    ``overflow_fallback_count`` counts the batches the dedup overflow
    guard sent to the full-capacity step."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.batches = 0
        self.real_ids = 0
        self.bucketed_slots = 0
        self.static_slots = 0
        self.compile_count = 0
        self.fallback_count = 0
        self.overflow_fallback_count = 0
        # key -> [occupancy, bucketed cap, static cap], summed over batches
        self.per_key: Dict[str, list] = {}
        # signature -> dispatches; signature -> its programs' wire ledger
        self.dispatch_counts: Dict[Tuple[int, ...], int] = {}
        self.wire_ledgers: Dict[Tuple[int, ...], Dict[str, float]] = {}
        # signatures whose program (the port's DMP clone) was built
        self.programs: set = set()

    def record_batch(
        self,
        keys: Sequence[str],
        occupancy: Sequence[int],
        bucketed_caps: Sequence[int],
        static_caps: Sequence[int],
    ) -> None:
        self.batches += 1
        for k, occ, bc, sc in zip(keys, occupancy, bucketed_caps,
                                  static_caps):
            self.real_ids += int(occ)
            self.bucketed_slots += int(bc)
            self.static_slots += int(sc)
            acc = self.per_key.setdefault(k, [0, 0, 0])
            acc[0] += int(occ)
            acc[1] += int(bc)
            acc[2] += int(sc)

    def record_dispatch(self, signature: Sequence[int]) -> None:
        sig = tuple(signature)
        self.dispatch_counts[sig] = self.dispatch_counts.get(sig, 0) + 1

    def record_compile(self, signature: Sequence[int],
                       wire_ledger: Optional[Dict[str, float]] = None
                       ) -> None:
        """A signature's program kind ran for the first time; its wire
        ledger merges into the signature's (a signature may have several
        kinds: the fused step, the semi-sync halves)."""
        self.compile_count += 1
        if wire_ledger is not None:
            acc = self.wire_ledgers.setdefault(tuple(signature), {})
            for k, v in wire_ledger.items():
                acc[k] = acc.get(k, 0.0) + float(v)

    def record_program(self, signature: Sequence[int]) -> None:
        """A signature's program was built (at first use or by the
        pipeline's ``warmup``, before any dispatch)."""
        self.programs.add(tuple(signature))

    def record_fallback(self) -> None:
        self.fallback_count += 1

    def record_overflow_fallback(self) -> None:
        """A batch's distinct-id demand passed its bucketed signature's
        dedup capacity, so it ran the full-capacity step."""
        self.overflow_fallback_count += 1

    @property
    def program_count(self) -> int:
        """Signatures whose program was built."""
        return len(self.programs)

    def padding_efficiency(self) -> float:
        """Real ids / bucketed id slots, in (0, 1]."""
        return self.real_ids / max(1, self.bucketed_slots)

    def static_efficiency(self) -> float:
        """Real ids / static id slots: what the unbucketed stack gets."""
        return self.real_ids / max(1, self.static_slots)

    def padded_bytes_ratio(self) -> float:
        """Bucketed / static id slots shipped (below 1: padding saved)."""
        return self.bucketed_slots / max(1, self.static_slots)

    def scalar_metrics(self, prefix: str = "bucketing") -> Dict[str, float]:
        """The aggregate counters, the per-key mean occupancy and
        capacities, and the per-step wire bytes by tag."""
        out = {
            f"{prefix}/batches": float(self.batches),
            f"{prefix}/compile_count": float(self.compile_count),
            f"{prefix}/dispatch_count": float(
                sum(self.dispatch_counts.values())),
            f"{prefix}/program_count": float(self.program_count),
            f"{prefix}/fallback_count": float(self.fallback_count),
            f"{prefix}/overflow_fallback_count": float(
                self.overflow_fallback_count),
            f"{prefix}/padding_efficiency": self.padding_efficiency(),
            f"{prefix}/static_efficiency": self.static_efficiency(),
            f"{prefix}/padded_bytes_ratio": self.padded_bytes_ratio(),
        }
        n = max(1, self.batches)
        for k, (occ, bc, sc) in self.per_key.items():
            out[counter_key(prefix, k, "mean_occupancy")] = occ / n
            out[counter_key(prefix, k, "mean_bucketed_cap")] = bc / n
            out[counter_key(prefix, k, "mean_static_cap")] = sc / n
        # the ledgers land under the reserved ``wire`` namespace, not
        # ``prefix``: the keys ``obs report``'s wire sections read
        for tag, nbytes in self.wire_bytes_per_step().items():
            out[counter_key("wire", tag, "bytes_per_step")] = float(nbytes)
        return out

    def wire_bytes_per_step(self) -> Dict[str, float]:
        """Mean wire bytes a step by tag: each signature's ledger weighted
        by its dispatches, over the dispatches of signatures that have a
        ledger; empty until one has."""
        total: Dict[str, float] = {}
        dispatches = 0
        for sig, ledger in self.wire_ledgers.items():
            n = self.dispatch_counts.get(sig, 0)
            if not n:
                continue
            dispatches += n
            for tag, nbytes in ledger.items():
                total[tag] = total.get(tag, 0.0) + nbytes * n
        if not dispatches:
            return {}
        return {tag: v / dispatches for tag, v in total.items()}


class KernelStats:
    """Per-table row traffic of the pooled lookups, counted on the host:
    the rows a per-id kernel reads (one per valid id) and the rows the
    dedup kernels' distinct ids stand for (one per distinct id), priced
    at the table's row bytes (``hbm_row_bytes`` at the distinct rows with
    ``dedup``, at every id without).  A model of the traffic from the ids
    alone; no device counter is read."""

    def __init__(self, dedup: bool = True):
        self.dedup = bool(dedup)
        self.reset()

    def reset(self) -> None:
        self.batches = 0
        # table -> [per-id rows, distinct rows, row bytes priced]
        self.per_table: Dict[str, list] = {}

    def record_lookup(self, table: str, ids, row_bytes: int) -> None:
        """One table's valid ids (host array or tensor)."""
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        ids = np.asarray(ids).reshape(-1)
        per_id = int(ids.shape[0])
        distinct = int(np.unique(ids).shape[0]) if per_id else 0
        self.record_counts(table, per_id, distinct, row_bytes)

    def record_counts(self, table: str, per_id_rows: int,
                      distinct_rows: int, row_bytes: int) -> None:
        acc = self.per_table.setdefault(table, [0, 0, 0])
        acc[0] += int(per_id_rows)
        acc[1] += int(distinct_rows)
        acc[2] += (int(distinct_rows) if self.dedup
                   else int(per_id_rows)) * int(row_bytes)

    def record_batch_done(self) -> None:
        self.batches += 1

    def distinct_ratio(self, table: Optional[str] = None) -> float:
        """Distinct over per-id rows, in (0, 1]."""
        rows = ([self.per_table.get(table, [0, 0, 0])] if table is not None
                else list(self.per_table.values()))
        return sum(r[1] for r in rows) / max(1, sum(r[0] for r in rows))

    def hbm_row_bytes(self) -> int:
        return sum(r[2] for r in self.per_table.values())

    def scalar_metrics(self, prefix: str = "kernels") -> Dict[str, float]:
        out = {
            f"{prefix}/batches": float(self.batches),
            f"{prefix}/distinct_ratio": self.distinct_ratio(),
            f"{prefix}/hbm_row_bytes": float(self.hbm_row_bytes()),
        }
        for t, (per_id, distinct, nbytes) in self.per_table.items():
            out[counter_key(prefix, t, "per_id_rows")] = float(per_id)
            out[counter_key(prefix, t, "distinct_rows")] = float(distinct)
            out[counter_key(prefix, t, "hbm_row_bytes")] = float(nbytes)
        return out


class TieredStats:
    """Counters of tiered embedding storage (``tiered/``): per table the
    cache's lookup, hit, insert and eviction counts (the MPZCH counter
    families' names), the host <-> card row traffic, and the prefetch
    timing that shows whether host reads hid behind the steps.  Host
    numbers only, recorded by ``TieredCollection`` and
    ``TieredPrefetcher``; ``scalar_metrics`` exports them flat under
    ``<prefix>/<table>/<counter>`` (:func:`counter_key`), which the
    health monitor reads."""

    _COUNTERS = (
        "lookup_count", "hit_count", "insert_count", "eviction_count",
        "fetch_rows", "writeback_rows", "staged_rows", "sync_fetch_rows",
        "id_violations", "flush_count", "occupancy", "capacity",
        "refreshed_rows",
    )

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.per_table: Dict[str, Dict[str, float]] = {}
        self.batches = 0
        # prefetch timing: the background staging work, and the time the
        # consumer blocked waiting for it (overlap = 1 - wait / stage)
        self.stage_seconds = 0.0
        self.wait_seconds = 0.0

    def _t(self, table: str) -> Dict[str, float]:
        acc = self.per_table.get(table)
        if acc is None:
            acc = {k: 0.0 for k in self._COUNTERS}
            self.per_table[table] = acc
        return acc

    def record_remap(self, table: str, lookups: int, hits: int,
                     inserts: int, evictions: int, occupancy: int) -> None:
        acc = self._t(table)
        acc["lookup_count"] += lookups
        acc["hit_count"] += hits
        acc["insert_count"] += inserts
        acc["eviction_count"] += evictions
        acc["occupancy"] = float(occupancy)

    def record_capacity(self, table: str, cache_rows: int) -> None:
        """A table's cache slots, so that ``scalar_metrics`` exports
        ``occupancy_rate`` = occupancy / capacity."""
        self._t(table)["capacity"] = float(cache_rows)

    def record_violations(self, table: str, n: int) -> None:
        """Invalid (out-of-range or negative) ids dropped before the
        remap: they never claim a slot."""
        self._t(table)["id_violations"] += n

    def record_io(self, table: str, fetched: int, written_back: int,
                  staged: int = 0, sync: int = 0) -> None:
        acc = self._t(table)
        acc["fetch_rows"] += fetched
        acc["writeback_rows"] += written_back
        acc["staged_rows"] += staged
        acc["sync_fetch_rows"] += sync

    def record_refresh(self, table: str, rows: int) -> None:
        """Resident rows overwritten in place by a delta-stream refresh
        (``inference/freshness.py``): not fetch traffic, so a publish does
        not read as a burst of cache misses."""
        self._t(table)["refreshed_rows"] += rows

    def record_flush(self, table: str) -> None:
        self._t(table)["flush_count"] += 1

    def record_batch(self) -> None:
        self.batches += 1

    def record_stage(self, seconds: float) -> None:
        self.stage_seconds += seconds

    def record_wait(self, seconds: float) -> None:
        self.wait_seconds += seconds

    def hit_rate(self, table: Optional[str] = None) -> float:
        """Cache hit rate over the id stream (one table, or all)."""
        tables = [table] if table is not None else list(self.per_table)
        hits = sum(self._t(t)["hit_count"] for t in tables)
        looks = sum(self._t(t)["lookup_count"] for t in tables)
        return hits / max(1.0, looks)

    def prefetch_overlap_ratio(self) -> float:
        """The share of background staging time hidden behind the steps:
        1 - blocked wait / staged work, clamped to [0, 1] (1.0: every
        host read was ready before its step needed it)."""
        if self.stage_seconds <= 0.0:
            return 0.0
        return min(1.0, max(0.0, 1.0 - self.wait_seconds
                            / self.stage_seconds))

    def scalar_metrics(self, prefix: str = "tiered") -> Dict[str, float]:
        """Flat scalars under ``<prefix>/<table>/<counter>`` and the
        subsystem's aggregates."""
        out: Dict[str, float] = {
            f"{prefix}/batches": float(self.batches),
            f"{prefix}/hit_rate": self.hit_rate(),
            f"{prefix}/prefetch_overlap_ratio": self.prefetch_overlap_ratio(),
            f"{prefix}/stage_seconds": self.stage_seconds,
            f"{prefix}/wait_seconds": self.wait_seconds,
        }
        for t, acc in self.per_table.items():
            for k, v in acc.items():
                out[counter_key(prefix, t, k)] = float(v)
            if acc["lookup_count"]:
                out[counter_key(prefix, t, "hit_rate")] = (
                    acc["hit_count"] / acc["lookup_count"])
            if acc["capacity"]:
                out[counter_key(prefix, t, "occupancy_rate")] = (
                    acc["occupancy"] / acc["capacity"])
        return out


class EventLog:
    """A structured JSONL log of framework events, thread-safe: one JSON
    object a line with the wall-clock ``t``, a monotonic ``mono`` and the
    event's fields.  One append handle, opened on the first emit; with
    ``autoflush`` each line is flushed as written and the path re-checked,
    so an external rotation (a new inode or a removed file) reopens it;
    without, :meth:`flush` does both.  :meth:`close` is idempotent and a
    later emit reopens in append mode."""

    def __init__(self, path: str, autoflush: bool = True):
        self.path = path
        self.autoflush = autoflush
        self._lock = threading.Lock()
        self._f = None
        self._ino = None

    def _handle(self):
        """The open handle (lock held), reopened after a close or a
        rotation of the path."""
        if self._f is not None and not self._f.closed:
            try:
                fresh = os.stat(self.path).st_ino == self._ino
            except OSError:
                fresh = False
            if fresh:
                return self._f
            self._f.close()
        self._f = open(self.path, "a", encoding="utf-8")
        self._ino = os.fstat(self._f.fileno()).st_ino
        return self._f

    def emit(self, event: str, **fields) -> None:
        rec = {"t": time.time(), "mono": time.monotonic(), "event": event,
               **fields}
        line = json.dumps(rec, default=str)
        with self._lock:
            if self.autoflush:
                f = self._handle()
                f.write(line + "\n")
                f.flush()
            else:
                if self._f is None or self._f.closed:
                    self._handle()
                self._f.write(line + "\n")

    def flush(self) -> None:
        with self._lock:
            if self._f is not None and not self._f.closed:
                self._f.flush()
                self._handle()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                if not self._f.closed:
                    self._f.close()
                self._f = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def read(self):
        """Every record written so far."""
        self.flush()
        if not os.path.exists(self.path):
            return []
        with open(self.path, encoding="utf-8") as f:
            return [json.loads(ln) for ln in f if ln.strip()]
