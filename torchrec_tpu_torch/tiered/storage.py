"""Tiered embedding storage: the storage tiers and the TieredTable
(``torchrec_tpu/tiered/storage.py``).

A table too large for the card keeps its cold rows on the host, and a
card-resident cache of ``cache_rows`` slots serves the hot working set:

  card tier  : ``cache_rows`` slots of a normal table-wise or
               data-parallel table of the train state (slot == table
               row; the device only ever sees cache-slot ids).
  host tier  : cold rows in host RAM, either the whole table
               (``RamStore``) or a budgeted LRU row cache
               (``HostRamCache``) in front of the disk tier.
  disk tier  : ``DiskStore``: an ``np.memmap`` WORK file for the live
               working copy plus crash-safe generational snapshots that
               ``flush()`` publishes with the Checkpointer's recipe (tmp
               file, fsync, atomic rename, directory fsync).  A kill
               between flushes never tears durable state: reopening
               loads the last published generation.

A host or disk row is PACKED: ``embedding_dim`` weight columns followed by
the per-row fused-optimizer slot columns (:func:`opt_slot_widths`), all
float32.  Packing makes every fill and write-back one gather or scatter,
and makes tiered training bit-exact against an all-device run: a row's
optimizer state travels with the row, so a recycled slot never leaks
another id's momentum.

The id -> slot map is the port's native transformer
(``inference/serving.py``: ``IdTransformer`` for ``"lru"``,
``LfuIdTransformer`` for ``"lfu"`` and ``"lfu_aged"``), built with the
host library, whose failed build raises.  The pure-Python
``PyLfuIdTransformer`` is used only when the caller asks for it
(``python_transformer=True``); there is no silent fallback.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

BYTES_F32 = 4

_GEN_SEP = ".g"

# a host-tier read or write of more rows than this splits over threads
# (numpy's fancy indexing releases the GIL)
_PARALLEL_ROWS = 1 << 16
_IO_THREADS = min(8, os.cpu_count() or 1)


def opt_slot_widths(config, dim: int) -> Dict[str, int]:
    """Per-row fused-optimizer slot column widths for a table of ``dim``
    columns (``ops/fused_update.py``'s row layouts; scalar slots such as
    Adam's step counter are shared, not per row, and are not tiered)."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    t = config.optim
    if t in (EmbOptimType.SGD, EmbOptimType.LARS_SGD):
        return {}
    if t == EmbOptimType.ROWWISE_ADAGRAD:
        return {"momentum": 1}
    if t == EmbOptimType.ADAGRAD:
        return {"momentum": dim}
    if t in (EmbOptimType.ADAM, EmbOptimType.LAMB):
        return {"m": dim, "v": dim}
    if t in (EmbOptimType.PARTIAL_ROWWISE_ADAM,
             EmbOptimType.PARTIAL_ROWWISE_LAMB):
        return {"m": dim, "v": 1}
    raise ValueError(f"unsupported fused optimizer {t}")


def _chunk_rows(rows: int, width: int, budget_bytes: int = 64 << 20) -> int:
    return max(1, budget_bytes // max(1, width * BYTES_F32))


def _pieces(n: int):
    """``[(start, end), ...]`` splitting ``n`` rows over the IO threads."""
    k = min(_IO_THREADS, max(1, n // _PARALLEL_ROWS))
    edges = np.linspace(0, n, k + 1).astype(np.int64)
    return list(zip(edges[:-1], edges[1:]))


def _take_rows(array, ids: np.ndarray, out: Optional[np.ndarray] = None
               ) -> np.ndarray:
    """``array[ids]`` into ``out`` (a fresh array if None), split over
    threads for a large read."""
    if out is None:
        out = np.empty((len(ids), array.shape[1]), np.float32)
    pieces = _pieces(len(ids))
    if len(pieces) == 1:
        np.take(array, ids, axis=0, out=out)
        return out
    with ThreadPoolExecutor(len(pieces)) as pool:
        list(pool.map(lambda p: np.take(array, ids[p[0]:p[1]], axis=0,
                                        out=out[p[0]:p[1]]), pieces))
    return out


def _put_rows(array, ids: np.ndarray, values: np.ndarray) -> None:
    """``array[ids] = values``, split over threads for a large write
    (the ids of one write are distinct)."""
    pieces = _pieces(len(ids))
    if len(pieces) == 1:
        array[ids] = values
        return

    def put(p):
        array[ids[p[0]:p[1]]] = values[p[0]:p[1]]

    with ThreadPoolExecutor(len(pieces)) as pool:
        list(pool.map(put, pieces))


class RamStore:
    """Whole-table host-RAM tier: ``rows`` x ``width`` float32, filled in
    place by ``init_fn(buf)`` when given (else left for a later
    ``load``)."""

    def __init__(self, rows: int, width: int, init_fn=None):
        self.rows, self.width = rows, width
        self.array = np.empty((rows, width), np.float32)
        if init_fn is not None:
            init_fn(self.array)

    def read(self, ids: np.ndarray, out: Optional[np.ndarray] = None
             ) -> np.ndarray:
        return _take_rows(self.array, ids, out)

    def write(self, ids: np.ndarray, values: np.ndarray) -> None:
        _put_rows(self.array, ids, values)

    def flush(self) -> Optional[int]:
        """RAM tiers have no durable medium: a checkpoint embeds their
        rows in its payload instead."""
        return None

    def snapshot(self) -> np.ndarray:
        return np.array(self.array)

    def load(self, buf: np.ndarray) -> None:
        self.array[...] = buf


class DiskStore:
    """Crash-safe disk tier: a memmap work file and generational snapshots.

    For base path ``P``: ``P.work`` is the live working copy (never
    authoritative across a crash: it is rebuilt from the newest snapshot
    on open); ``P.g{N}`` are immutable published snapshots (``flush()``
    writes ``P.g{N+1}.tmp``, fsyncs it, renames it atomically and fsyncs
    the directory; the last ``keep_generations`` are kept, so a
    checkpoint that pinned generation N survives a later flush of N+1);
    ``P`` alone is the single-file layout of the host-offloaded tables,
    read as generation 0 when no ``P.g*`` snapshot exists.

    The store holds ``rows`` x ``width`` float32; a fresh table (no
    snapshot on disk) is filled by ``init_fn`` and published at once as
    generation 1, so a kill before the first ``flush()`` reopens to the
    initial state."""

    def __init__(self, path: str, rows: int, width: int, init_fn=None,
                 keep_generations: int = 2):
        if keep_generations < 1:
            raise ValueError("keep_generations must be >= 1")
        self.path = path
        self.rows, self.width = rows, width
        self.keep_generations = keep_generations
        self._work_path = path + ".work"
        self._sweep_tmp()
        gens = self._generations()
        expected = rows * width * BYTES_F32
        if gens:
            src = self._gen_path(gens[-1])
            actual = os.path.getsize(src)
            if actual != expected:
                raise ValueError(
                    f"{src}: size {actual} does not match table shape "
                    f"({rows}, {width}) float32 = {expected} bytes: config "
                    "changed?")
            self.generation = gens[-1]
            self._rebuild_work(src)
        else:
            self.array = np.memmap(self._work_path, dtype=np.float32,
                                   mode="w+", shape=(rows, width))
            if init_fn is not None:
                init_fn(self.array)
            self.generation = 0
            self.flush()

    # -- snapshot discovery ------------------------------------------------

    def _gen_path(self, n: int) -> str:
        return self.path if n == 0 else f"{self.path}{_GEN_SEP}{n}"

    def _generations(self) -> Tuple[int, ...]:
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path) + _GEN_SEP
        out = []
        if os.path.exists(self.path):
            out.append(0)
        if os.path.isdir(d):
            for name in os.listdir(d):
                if name.startswith(base) and not name.endswith(".tmp"):
                    try:
                        out.append(int(name[len(base):]))
                    except ValueError:
                        continue
        return tuple(sorted(out))

    def _sweep_tmp(self) -> None:
        """Remove torn snapshot attempts (a crash mid-flush): they are
        never read."""
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path) + _GEN_SEP
        if not os.path.isdir(d):
            return
        for name in os.listdir(d):
            if name.startswith(base) and name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass

    def _rebuild_work(self, src: str) -> None:
        """The work file as a copy of a snapshot: a crashed process's
        stale work content is discarded."""
        work = np.memmap(self._work_path, dtype=np.float32, mode="w+",
                         shape=(self.rows, self.width))
        snap = np.memmap(src, dtype=np.float32, mode="r",
                         shape=(self.rows, self.width))
        step = _chunk_rows(self.rows, self.width)
        for s in range(0, self.rows, step):
            work[s:s + step] = snap[s:s + step]
        del snap
        self.array = work

    # -- row IO ------------------------------------------------------------

    def read(self, ids: np.ndarray, out: Optional[np.ndarray] = None
             ) -> np.ndarray:
        return _take_rows(self.array, ids, out)

    def write(self, ids: np.ndarray, values: np.ndarray) -> None:
        _put_rows(self.array, ids, values)

    # -- durability --------------------------------------------------------

    def flush(self) -> int:
        """Publish the work file as the next immutable generation and
        return its number.  A kill at any point leaves the previous
        generation (tmp never renamed) or the new one (the rename is
        atomic), never a torn snapshot."""
        nxt = self.generation + 1
        tmp = self._gen_path(nxt) + ".tmp"
        step = _chunk_rows(self.rows, self.width)
        with open(tmp, "wb") as f:
            for s in range(0, self.rows, step):
                f.write(np.ascontiguousarray(self.array[s:s + step]))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._gen_path(nxt))
        self._fsync_dir()
        self.generation = nxt
        self._prune()
        return nxt

    def _fsync_dir(self) -> None:
        d = os.path.dirname(self.path) or "."
        try:
            fd = os.open(d, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _prune(self) -> None:
        gens = [g for g in self._generations() if g != 0]
        for g in gens[:-self.keep_generations]:
            try:
                os.remove(self._gen_path(g))
            except OSError:
                pass

    def load_generation(self, n: int) -> None:
        """Rebuild the work file from snapshot ``n`` (a checkpoint
        restore).  Later flushes go on past the newest generation on
        disk, so restoring an old checkpoint never overwrites a newer
        snapshot another checkpoint may pin."""
        src = self._gen_path(int(n))
        if not os.path.exists(src):
            raise FileNotFoundError(
                f"tiered-storage generation {n} at {src} is missing: pruned "
                f"by a later flush?  Raise keep_generations (now "
                f"{self.keep_generations}) to cover the checkpoint "
                "retention window.")
        gens = self._generations()
        self.generation = max(gens) if gens else int(n)
        self._rebuild_work(src)


class HostRamCache:
    """A budgeted host-RAM tier over a backing store: an LRU write-back
    row cache of at most ``budget_rows`` packed rows.  Reads pull misses
    from the backing store and keep them; writes stay in RAM until they
    are evicted or flushed.  Not thread-safe by itself: ``TieredTable``
    serializes access under its lock."""

    def __init__(self, backing, budget_rows: int):
        if budget_rows < 1:
            raise ValueError("host RAM budget must be >= 1 row")
        self.backing = backing
        self.budget_rows = budget_rows
        self.rows, self.width = backing.rows, backing.width
        self._lru: "collections.OrderedDict[int, np.ndarray]" = (
            collections.OrderedDict())
        self._dirty: set = set()

    def read(self, ids: np.ndarray, out: Optional[np.ndarray] = None
             ) -> np.ndarray:
        if out is None:
            out = np.empty((len(ids), self.width), np.float32)
        miss_pos = []
        for i, g in enumerate(ids):
            g = int(g)
            row = self._lru.get(g)
            if row is None:
                miss_pos.append(i)
            else:
                self._lru.move_to_end(g)
                out[i] = row
        if miss_pos:
            miss_ids = np.asarray([int(ids[i]) for i in miss_pos], np.int64)
            fetched = self.backing.read(miss_ids)
            for j, i in enumerate(miss_pos):
                out[i] = fetched[j]
                self._insert(int(ids[i]), fetched[j], dirty=False)
        return out

    def write(self, ids: np.ndarray, values: np.ndarray) -> None:
        for i, g in enumerate(ids):
            self._insert(int(g), values[i], dirty=True)

    def _insert(self, g: int, row: np.ndarray, dirty: bool) -> None:
        self._lru[g] = np.array(row, np.float32)
        self._lru.move_to_end(g)
        if dirty:
            self._dirty.add(g)
        while len(self._lru) > self.budget_rows:
            old, old_row = self._lru.popitem(last=False)
            if old in self._dirty:
                self._dirty.discard(old)
                self.backing.write(np.asarray([old], np.int64),
                                   old_row[None, :])

    def flush(self) -> Optional[int]:
        """Write every dirty row to the backing store, then publish the
        backing store's snapshot."""
        if self._dirty:
            ids = np.asarray(sorted(self._dirty), np.int64)
            vals = np.stack([self._lru[int(g)] for g in ids])
            self.backing.write(ids, vals)
            self._dirty.clear()
        return self.backing.flush()

    def load_generation(self, n: int) -> None:
        self._lru.clear()
        self._dirty.clear()
        self.backing.load_generation(n)


@dataclasses.dataclass
class TieredIO:
    """One batch's cache maintenance plan for one table: evicted rows are
    read back from cache slots ``writeback_slots`` into host rows
    ``writeback_logical``, then host rows ``fetch_logical`` are scattered
    into cache slots ``fetch_slots``.  Fetches are LOGICAL ids: their
    values resolve against the host tier after the write-back (or from
    the prefetch stage, which leaves out rows with a pending write-back),
    so an id evicted and fetched again never reads a stale host copy."""

    fetch_slots: np.ndarray
    fetch_logical: np.ndarray
    writeback_slots: np.ndarray
    writeback_logical: np.ndarray


def plan_cache_io(transformer, raw_ids: np.ndarray, *, table_name: str,
                  cache_rows: int) -> Tuple[np.ndarray, TieredIO, int]:
    """The remap shared by :meth:`TieredTable.remap` and the synchronous
    path (``modules/host_offload.py``): one stateful transform over a
    batch's ids, the recycled-twice guard and the fresh-slot fetch mask;
    returns ``(slots, TieredIO, size_before)``."""
    raw_ids = np.ascontiguousarray(raw_ids, np.int64)
    size_before = len(transformer)
    slots, ev_g, ev_s = transformer.transform(raw_ids)
    # two distinct live ids sharing one slot in a batch cannot be
    # represented (they would share a device row this step); checked on
    # the id -> slot map itself (a slot can be assigned, evicted and
    # assigned again in one call while appearing once among the
    # evictions): each slot holds one owner, and every occurrence of the
    # slot must be that owner's id (linear in the batch and the cache, no
    # sort)
    n_slots = max(cache_rows, int(slots.max()) + 1 if slots.size else 0)
    owner = np.empty((n_slots,), np.int64)
    owner[slots] = raw_ids
    if not np.array_equal(owner[slots], raw_ids):
        raise ValueError(
            f"table {table_name}: device cache ({cache_rows} rows) cannot "
            f"hold this step's distinct-id working set "
            f"({len(np.unique(raw_ids))} ids across the batch group): a slot "
            "was recycled twice within one step; raise cache_rows (or the "
            "cache_load_factor) past the per-step distinct-id count")
    # fetch = first occurrence of each freshly assigned slot (an evicted
    # slot recycled, or the map grown past its old size); whether a slot
    # is fresh depends on the slot alone, so the first occurrences are
    # searched among the fresh positions only
    evicted = np.zeros((n_slots,), bool)
    evicted[ev_s] = True
    cand = np.flatnonzero(evicted[slots] | (slots >= size_before))
    _, first_idx = np.unique(slots[cand], return_index=True)
    fresh = np.zeros((len(slots),), bool)
    fresh[cand[first_idx]] = True
    io = TieredIO(fetch_slots=slots[fresh], fetch_logical=raw_ids[fresh],
                  writeback_slots=ev_s, writeback_logical=ev_g)
    return slots, io, size_before


class TieredTable:
    """One logical embedding table across the storage tiers.

    The card tier is ``cache_rows`` slots of a train-state table (the
    rows live in the train state; this object owns the logical-id -> slot
    map, the host and disk tiers and the counters).  ``table_name`` keys
    the counters and the checkpoint entry of the ``num_embeddings`` x
    ``embedding_dim`` logical table; ``opt_slots`` (slot -> columns, from
    :func:`opt_slot_widths`) packs the fused optimizer's state beside the
    weights.  The cold store is host RAM (``RamStore``), or a
    ``DiskStore`` at ``storage_path`` (``keep_generations`` snapshots)
    with at most ``host_budget_rows`` rows in RAM in front of it when
    given; rows start from ``init_fn(start, end) -> [n, D]`` or the
    ``seed``-ed uniform default (the JAX table's values), the slot columns
    from zero.  ``init_fn`` must be a pure function of the rows it is
    asked for: its chunks fill on several threads.

    ``eviction_policy``: ``"lru"``, ``"lfu"`` (minimum count, LRU within
    a count) or ``"lfu_aged"`` (the DistanceLFU score ``count /
    distance^decay_exponent``: LFU with aging), on the native transformer;
    ``python_transformer=True`` takes ``PyLfuIdTransformer`` for the two
    LFU policies instead."""

    def __init__(  # the JAX table's materialization knobs, one for one
        self,
        table_name: str,
        num_embeddings: int,
        embedding_dim: int,
        cache_rows: int,
        opt_slots: Optional[Dict[str, int]] = None,
        host_budget_rows: Optional[int] = None,
        storage_path: Optional[str] = None,
        eviction_policy: str = "lfu_aged",
        decay_exponent: float = 1.0,
        init_fn=None,
        seed: int = 0,
        keep_generations: int = 2,
        python_transformer: bool = False,
    ):
        from torchrec_tpu_torch.inference.serving import (
            IdTransformer,
            LfuIdTransformer,
            PyLfuIdTransformer,
        )

        self.table_name = table_name
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.cache_rows = cache_rows
        # deterministic packed column order: weights, then sorted slots
        self.opt_slots = dict(sorted((opt_slots or {}).items()))
        self.row_width = embedding_dim + sum(self.opt_slots.values())
        self.eviction_policy = eviction_policy
        self._lock = threading.RLock()

        def fill(buf: np.ndarray) -> None:
            self._init_rows(buf, init_fn, seed)

        if storage_path is not None:
            store = DiskStore(storage_path, num_embeddings, self.row_width,
                              fill, keep_generations=keep_generations)
            if host_budget_rows is not None:
                store = HostRamCache(store, host_budget_rows)
        else:
            store = RamStore(num_embeddings, self.row_width, fill)
        self.store = store

        if eviction_policy == "lru":
            if python_transformer:
                raise ValueError("python_transformer covers the LFU "
                                 "policies; 'lru' is native only")
            self._make_transformer = lambda: IdTransformer(cache_rows)
        elif eviction_policy in ("lfu", "lfu_aged"):
            pol = "lfu" if eviction_policy == "lfu" else "distance_lfu"
            cls = PyLfuIdTransformer if python_transformer else (
                LfuIdTransformer)
            self._make_transformer = lambda: cls(cache_rows, pol,
                                                 decay_exponent)
        else:
            raise ValueError(f"unknown eviction policy {eviction_policy!r}")
        self._transformer = self._make_transformer()
        # host shadow of the transformer's id -> slot map: the transformer
        # exposes transform() only, and checkpoint sync and the logical
        # table's reconstruction enumerate the residents
        self._resident: Dict[int, int] = {}

    # -- init --------------------------------------------------------------

    def _init_rows(self, buf: np.ndarray, init_fn, seed: int) -> None:
        """Chunked fill (a memmap table never materializes whole): weight
        columns from ``init_fn(start, end)`` (chunks in parallel) or the
        seeded uniform default (one stream, so in order), slot columns
        zero."""
        D = self.embedding_dim
        R = self.num_embeddings
        step = _chunk_rows(R, self.row_width)
        chunks = [(s, min(s + step, R)) for s in range(0, R, step)]
        if init_fn is not None:
            def fill(se):
                s, e = se
                buf[s:e, :D] = init_fn(s, e)
                buf[s:e, D:] = 0.0

            with ThreadPoolExecutor(_IO_THREADS) as pool:
                list(pool.map(fill, chunks))
            return
        rng = np.random.RandomState(seed)
        scale = 1.0 / np.sqrt(R)
        for s, e in chunks:
            buf[s:e, :D] = rng.uniform(-scale, scale,
                                       size=(e - s, D)).astype(np.float32)
            buf[s:e, D:] = 0.0

    # -- cache mapping -----------------------------------------------------

    @property
    def occupancy(self) -> int:
        return len(self._resident)

    def remap(self, raw_ids: np.ndarray
              ) -> Tuple[np.ndarray, TieredIO, Tuple[int, int, int]]:
        """Map logical ids to cache slots; returns ``(slots, io, (hits,
        inserts, evictions))``.  Called in stream order from one thread
        (the transformer is stateful); ids already in
        ``[0, num_embeddings)``."""
        slots, io, size_before = plan_cache_io(
            self._transformer, raw_ids, table_name=self.table_name,
            cache_rows=self.cache_rows)
        ev_g = io.writeback_logical
        for g in ev_g.tolist():
            self._resident.pop(g, None)
        self._resident.update(zip(io.fetch_logical.tolist(),
                                  io.fetch_slots.tolist()))
        if len(self._resident) != len(self._transformer):
            raise AssertionError(
                f"table {self.table_name}: resident shadow "
                f"({len(self._resident)}) diverged from the transformer "
                f"({len(self._transformer)})")
        inserts = len(self._transformer) - size_before + len(ev_g)
        hits = len(raw_ids) - inserts
        return slots, io, (hits, inserts, len(ev_g))

    def resident_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(logical ids, slots) of every cache-resident row."""
        if not self._resident:
            e = np.zeros((0,), np.int64)
            return e, e
        ids = np.fromiter(self._resident.keys(), np.int64,
                          count=len(self._resident))
        slots = np.fromiter(self._resident.values(), np.int64,
                            count=len(self._resident))
        return ids, slots

    def reset_cache(self) -> None:
        """Forget the id -> slot map (a cold cache): a checkpoint restore
        does so, the host tier being the whole truth at a checkpoint;
        cache placement never changes a row's value."""
        self._transformer = self._make_transformer()
        self._resident = {}

    # -- host and disk IO --------------------------------------------------

    def read_rows(self, logical_ids: np.ndarray,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """``[k, row_width]`` packed rows (into ``out`` when given).
        Thread-safe: a prefetch stage reads while the pipeline writes
        back other rows."""
        with self._lock:
            return self.store.read(
                np.ascontiguousarray(logical_ids, np.int64), out)

    def write_rows(self, logical_ids: np.ndarray, values: np.ndarray
                   ) -> None:
        with self._lock:
            self.store.write(np.ascontiguousarray(logical_ids, np.int64),
                             np.ascontiguousarray(values, np.float32))

    def flush(self) -> Optional[int]:
        """Publish the host tier durably (see ``DiskStore``); returns the
        generation, or None for a RAM tier."""
        with self._lock:
            return self.store.flush()

    # -- checkpoint hooks --------------------------------------------------

    def checkpoint_state(self) -> Dict[str, np.ndarray]:
        """The host tier's checkpoint entry: a disk table pins the
        generation it just flushed; a RAM table embeds its rows."""
        gen = self.flush()
        if gen is not None:
            return {"generation": np.asarray(gen, np.int64)}
        return {"host_rows": self.store.snapshot()}

    def restore_checkpoint_state(self, st) -> None:
        """Reload the host tier from a checkpoint entry (numpy arrays or
        host tensors) and reset the cache cold."""
        with self._lock:
            if "generation" in st:
                self.store.load_generation(int(np.asarray(st["generation"])))
            else:
                buf = np.asarray(st["host_rows"], np.float32)
                if buf.shape != (self.num_embeddings, self.row_width):
                    raise ValueError(
                        f"table {self.table_name}: checkpoint host tier "
                        f"shape {buf.shape} != "
                        f"({self.num_embeddings}, {self.row_width})")
                self.store.load(buf)
        self.reset_cache()

    # -- views -------------------------------------------------------------

    def host_rows_view(self, start: int = 0, end: Optional[int] = None
                       ) -> np.ndarray:
        """Packed rows ``[start, end)`` of the host tier (a copy; reads
        through the RAM cache when budgeted)."""
        end = self.num_embeddings if end is None else end
        with self._lock:
            array = getattr(self.store, "array", None)
            if array is not None:  # a RAM or disk store: one slice
                return np.array(array[start:end])
        return self.read_rows(np.arange(start, end, dtype=np.int64))

    def host_weights_view(self) -> np.ndarray:
        """``[R, D]`` weight columns of the host tier (a copy)."""
        return self.host_rows_view()[:, :self.embedding_dim]
