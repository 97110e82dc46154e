"""Host-RAM offloaded embedding tables with a device cache, the
synchronous path (``torchrec_tpu/modules/host_offload.py``).

A table too large for the card lives in host memory (or a crash-safe
disk file, ``tiered.storage.DiskStore``), and a card cache of
``cache_rows`` slots serves the hot working set.  The native LRU id
transformer owns the logical-id -> slot map in the input pipeline, so
the device only sees slot ids.  Per batch, in front of the step:

  1. remap ids to slots (``tiered.storage.plan_cache_io``), collecting
     the evicted (slot, id) pairs and the freshly assigned ones;
  2. write the evicted slots' rows back to the host (one gather);
  3. read the assigned rows from the host and scatter them into the
     cache (one copy and one scatter).

Only the weights move: the slots' optimizer state stays with the slot,
so a recycled slot carries its previous occupant's state.  The tiered
subsystem (``tiered/``) packs the state with the row, prefetches the
host reads in the background, and guards and checkpoints the cache; this
module is the synchronous baseline it is timed against.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.parallel.types import ShardingType
from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor
from torchrec_tpu_torch.tiered.storage import TieredIO, plan_cache_io


class HostOffloadedTable:
    """One logical table in host memory and the id -> slot map of its
    card cache of ``cache_rows`` slots (the cache rows live in the train
    state as a normal ``[cache_rows, D]`` table).  ``storage_path`` backs
    the table with a ``DiskStore`` file (``flush()`` publishes a
    crash-safe generation); ``storage`` is any object with ``rows[ids]``,
    ``rows[ids] = v`` and ``flush()``.  Rows start from ``init_fn(start,
    end)`` or the ``seed``-ed uniform default (the JAX table's values)."""

    def __init__(self, table_name: str, num_embeddings: int,
                 embedding_dim: int, cache_rows: int, init_fn=None,
                 seed: int = 0, storage_path: Optional[str] = None,
                 storage=None):
        from torchrec_tpu_torch.inference.serving import IdTransformer

        self.table_name = table_name
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.cache_rows = cache_rows
        self._store = None
        if storage is not None:
            self.host_weights = storage
        elif storage_path is not None:
            from torchrec_tpu_torch.tiered.storage import DiskStore

            self._store = DiskStore(
                storage_path, num_embeddings, embedding_dim,
                init_fn=lambda buf: self._init_rows(buf, init_fn, seed))
            self.host_weights = self._store.array
        else:
            self.host_weights = np.empty((num_embeddings, embedding_dim),
                                         np.float32)
            self._init_rows(self.host_weights, init_fn, seed)
        self._transformer = IdTransformer(cache_rows)

    def _init_rows(self, buf: np.ndarray, init_fn, seed: int) -> None:
        """Chunked fill: ``init_fn(start, end)`` a chunk, or the seeded
        uniform stream."""
        rng = np.random.RandomState(seed)
        scale = 1.0 / np.sqrt(self.num_embeddings)
        step = max(1, (64 << 20) // (self.embedding_dim * 4))
        for s in range(0, self.num_embeddings, step):
            e = min(s + step, self.num_embeddings)
            if init_fn is not None:
                buf[s:e] = init_fn(s, e)
            else:
                buf[s:e] = rng.uniform(-scale, scale,
                                       size=(e - s, self.embedding_dim)
                                       ).astype(np.float32)

    def flush(self) -> Optional[int]:
        """Persist a disk-backed table (a crash-safe generation; its
        number), or flush an external storage; None for RAM."""
        if self._store is not None:
            return self._store.flush()
        flush = getattr(self.host_weights, "flush", None)
        if callable(flush):
            flush()
        return None


# one batch's cache maintenance plan, under the synchronous path's name
CacheIO = TieredIO


class HostOffloadedCollection:
    """The input pipeline's manager of host-offloaded tables:
    ``process(kjt)`` remaps each offloaded feature's ids to cache slots
    (out-of-range ids clamped into the table) and returns the per-table
    plans; ``apply_io`` writes the evicted rows back and fills the new
    ones in the live train state, in place.  Cache tables are table-wise
    or data-parallel with one column shard (slot == row)."""

    def __init__(self, tables: Dict[str, HostOffloadedTable],
                 feature_to_table: Dict[str, str]):
        self.tables = dict(tables)
        self.feature_to_table = dict(feature_to_table)
        self._plan_checked: set = set()

    def process(self, kjt: KeyedJaggedTensor
                ) -> Tuple[KeyedJaggedTensor, Dict[str, CacheIO]]:
        values = kjt.values().detach().cpu().numpy()
        lens = kjt.lengths().detach().cpu().numpy()
        lo, co = kjt._length_offsets(), kjt.cap_offsets()
        out = values.astype(np.int64, copy=True)
        ios: Dict[str, CacheIO] = {}
        # one transform call a table, so that the recycled-twice guard
        # covers the whole batch (per-feature calls could recycle a slot
        # of feature A in feature B's call of the same batch)
        by_table: Dict[str, List[Tuple[int, int, np.ndarray]]] = {}
        for f, key in enumerate(kjt.keys()):
            tname = self.feature_to_table.get(key)
            if tname is None:
                continue
            n = int(lens[lo[f]:lo[f + 1]].sum())
            if n == 0:
                continue
            s = co[f]
            raw = np.clip(values[s:s + n].astype(np.int64), 0,
                          self.tables[tname].num_embeddings - 1)
            by_table.setdefault(tname, []).append((s, n, raw))
        for tname, pieces in by_table.items():
            tbl = self.tables[tname]
            raw_all = np.concatenate([r for (_, _, r) in pieces])
            slots, io, _ = plan_cache_io(tbl._transformer, raw_all,
                                         table_name=tname,
                                         cache_rows=tbl.cache_rows)
            ios[tname] = io
            pos = 0
            for s, n, _ in pieces:
                out[s:s + n] = slots[pos:pos + n]
                pos += n
        return kjt.with_values(torch.from_numpy(out).to(
            kjt.values().dtype)), ios

    def _check_plan(self, dmp, tname: str) -> None:
        if tname in self._plan_checked:
            return
        ps = dmp.sharded_ebc.plan.get(tname)
        if ps is not None and not (
                ps.sharding_type in (ShardingType.TABLE_WISE,
                                     ShardingType.DATA_PARALLEL)
                and ps.num_col_shards == 1):
            raise ValueError(
                f"host-offloaded cache table {tname} must be TW or DP with a "
                f"single column shard (slot == row); plan has "
                f"{ps.sharding_type} with {ps.num_col_shards} column shards: "
                "a write-back would persist partial rows")
        self._plan_checked.add(tname)

    def apply_io(self, dmp, state, ios: Dict[str, CacheIO]):
        """Write evicted rows back to the host, then fill the assigned
        rows, on the current stream (the write-back's copy completes
        before the host rows are written)."""
        from torchrec_tpu_torch.tiered.collection import _to_host

        for tname, io in ios.items():
            tbl = self.tables[tname]
            self._check_plan(dmp, tname)
            if len(io.writeback_slots):
                rows = dmp.gather_row_state_tensor(state, tname,
                                                   io.writeback_slots, {})
                tbl.host_weights[io.writeback_logical] = _to_host(rows)
            if len(io.fetch_slots):
                state = dmp.scatter_row_state(
                    state, tname, io.fetch_slots,
                    np.asarray(tbl.host_weights[io.fetch_logical]), {})
        return state


def cache_rows_from_plan(plan, table_rows: Dict[str, int],
                         default_load_factor: Optional[float] = None
                         ) -> Dict[str, int]:
    """Cache slots of each FUSED_HOST_CACHED table of a plan:
    ``cache_load_factor * rows`` (the planner's fallback factor when the
    plan gives none; an explicit 0.0 is honoured, at least one slot);
    other tables are left out."""
    from torchrec_tpu_torch.parallel.types import (
        DEFAULT_CACHE_LOAD_FACTOR,
        EmbeddingComputeKernel,
    )

    if default_load_factor is None:
        # the planner's storage model uses the same fallback
        default_load_factor = DEFAULT_CACHE_LOAD_FACTOR
    out: Dict[str, int] = {}
    for name, ps in plan.items():
        if ps.compute_kernel != EmbeddingComputeKernel.FUSED_HOST_CACHED:
            continue
        clf = (ps.cache_load_factor if ps.cache_load_factor is not None
               else default_load_factor)
        rows = table_rows[name]
        out[name] = max(1, min(rows, int(rows * clf)))
    return out
