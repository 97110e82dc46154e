"""TieredCollection: the input pipeline's manager of tiered tables
(``torchrec_tpu/tiered/collection.py``).

* ``process_group(kjts)`` SANITIZES ids before the remap: out-of-range
  and negative ids go to slot 0 with weight 0.0 (the guardrails'
  sanitizer semantics) before they can touch the id transformer, so a
  corrupt batch never claims a slot, evicts a hot row or fetches a
  garbage host row; violations count per table in ``TieredStats``.
* ``apply_io`` moves PACKED rows (weights and per-row fused-optimizer
  slots) through ``DistributedModelParallel.gather_row_state_tensor`` /
  ``scatter_row_state`` on the caller's (the step's) CUDA stream: first
  the eviction write-backs (gathered after the previous step's update,
  copied to a pinned buffer and written to the host tier once that copy
  has completed), then the fills.  Fill rows come from the prefetch
  stage when one is given (``tiered/prefetch.py``: already on the device,
  copied on a side stream the step's stream waits for); rows with a
  pending write-back are read from the host tier after it landed.
* ``checkpoint_payload`` / ``checkpoint_restore`` keep the host tier
  consistent with the cache across checkpoints (``checkpoint.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.parallel.types import ShardingType
from torchrec_tpu_torch.sparse.jagged_tensor import KeyedJaggedTensor
from torchrec_tpu_torch.tiered.storage import TieredIO, TieredTable
from torchrec_tpu_torch.utils.profiling import TieredStats


# rows of one write-back piece
_WRITEBACK_ROWS = 1 << 18


def _to_host(rows: torch.Tensor) -> np.ndarray:
    """A device tensor's rows as a host array: copied into pinned memory
    on the current stream, and read only after that copy's event has
    completed (a non-blocking copy read early is a silently wrong row)."""
    if rows.device.type != "cuda":
        return rows.numpy()
    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    host.copy_(rows, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()


class TieredCollection:
    """Per-batch cache management for a set of :class:`TieredTable`.

    ``tables`` maps a table name to its ``TieredTable``;
    ``feature_to_table`` routes each tiered KJT feature to its table.
    ``sanitize`` nulls corrupt ids before they can claim slots (False:
    raise on one); ``stable_weights`` always attaches weights to the
    processed KJT (unit weights are exact in every pooling), so a
    corrupt batch does not change the step's inputs' structure; counters
    go to ``stats`` (a fresh ``TieredStats`` by default).

    ``vocab`` gates admission per table: a ``dynamic.
    DynamicVocabCollection`` (or a table -> ``DynamicVocab`` dict) whose
    ``admit_filter`` runs before the tiered remap.  Un-admitted ids take
    the sanitize route (slot 0, weight 0.0, bitwise an invalid id's), so
    pre-admission traffic changes nothing; the vocabulary counts them
    itself (``null_routed``), so they are not violations."""

    def __init__(
        self,
        tables: Dict[str, TieredTable],
        feature_to_table: Dict[str, str],
        sanitize: bool = True,
        stable_weights: bool = True,
        stats: Optional[TieredStats] = None,
        vocab=None,
    ):
        self.tables = dict(tables)
        self.feature_to_table = dict(feature_to_table)
        self.sanitize = sanitize
        self.stable_weights = stable_weights
        self.stats = stats if stats is not None else TieredStats()
        self.vocab = dict(getattr(vocab, "tables", vocab) or {})
        for tname, tbl in self.tables.items():
            # the exported occupancy_rate (the health monitor's input) is
            # normalized by this table's slots
            self.stats.record_capacity(tname, tbl.cache_rows)
        self._plan_checked: set = set()
        # remapped groups whose cache IO has not landed on the device yet:
        # their claims are in the host maps, so host and device disagree
        # until apply_io runs
        self._pending_io_groups = 0

    @property
    def pending_io_groups(self) -> int:
        """Batch groups remapped whose cache IO is not applied yet: the
        lookahead window in which the resident map runs ahead of the
        device."""
        return self._pending_io_groups

    # -- remap (input pipeline, host side) ---------------------------------

    def process(self, kjt: KeyedJaggedTensor
                ) -> Tuple[KeyedJaggedTensor, Dict[str, TieredIO]]:
        """:meth:`process_group` of one batch."""
        (kjt2,), ios = self.process_group([kjt])
        return kjt2, ios

    def process_group(self, kjts: List[KeyedJaggedTensor]
                      ) -> Tuple[List[KeyedJaggedTensor],
                                 Dict[str, TieredIO]]:
        """Remap a group of host KJTs (the local batches of one step) to
        cache-slot ids in ONE transform call per table.  The whole group
        runs as one step against one table state, so the recycled-slot
        guard must cover every local batch together, and one call gives
        one merged ``TieredIO`` per table: one gather and one scatter a
        table a step.  Every write-back of a call that does not raise
        refers to a resident from before the group, which keeps
        ``apply_io``'s write-back-then-fetch order exact.

        Invalid ids are dropped before the transform (module docstring);
        with ``stable_weights`` the output KJTs always carry weights (1
        for a clean id, 0 for a nulled one)."""
        values_l = [k.values().detach().cpu().numpy() for k in kjts]
        out_l = [v.astype(np.int64, copy=True) for v in values_l]
        w_in_l = [None if k.weights_or_none() is None
                  else k.weights_or_none().detach().cpu().numpy()
                  for k in kjts]
        out_w_l: List[Optional[np.ndarray]] = [
            np.array(w, np.float32) if w is not None
            else (np.ones((len(v),), np.float32) if self.stable_weights
                  else None)
            for w, v in zip(w_in_l, values_l)]
        ios: Dict[str, TieredIO] = {}
        # (local index, start, n, raw ids) pieces per table, group order
        by_table: Dict[str, List[Tuple[int, int, int, np.ndarray]]] = {}
        for li, kjt in enumerate(kjts):
            lens = kjt.lengths().detach().cpu().numpy()
            lo, co = kjt._length_offsets(), kjt.cap_offsets()
            for f, key in enumerate(kjt.keys()):
                tname = self.feature_to_table.get(key)
                if tname is None:
                    continue
                n = int(lens[lo[f]:lo[f + 1]].sum())
                if n == 0:
                    continue
                s = co[f]
                raw = values_l[li][s:s + n].astype(np.int64)
                by_table.setdefault(tname, []).append((li, s, n, raw))
            self.stats.record_batch()
        for tname, pieces in by_table.items():
            tbl = self.tables[tname]
            raw_all = np.concatenate([r for (_, _, _, r) in pieces])
            valid = (raw_all >= 0) & (raw_all < tbl.num_embeddings)
            n_bad = int((~valid).sum())
            if n_bad and not self.sanitize:
                raise ValueError(f"table {tname}: {n_bad} out-of-range ids "
                                 "in batch (sanitize=False)")
            if n_bad:
                self.stats.record_violations(tname, n_bad)
            vt = self.vocab.get(tname)
            if vt is not None:
                # gate mode: an un-admitted id is nulled like an invalid one
                gated = valid.copy()
                vids = raw_all[valid]
                if vids.size:
                    gated[valid] = vt.admit_filter(vids)
                valid = gated
            slots_all = np.zeros_like(raw_all)  # invalid -> null slot 0
            clean = raw_all[valid]
            if clean.size:
                slots, io, (hits, inserts, evs) = tbl.remap(clean)
                slots_all[valid] = slots
                self.stats.record_remap(tname, len(clean), hits, inserts,
                                        evs, tbl.occupancy)
            else:
                io = _empty_io()
            ios[tname] = io
            pos = 0
            for li, s, n, _ in pieces:
                seg_valid = valid[pos:pos + n]
                out_l[li][s:s + n] = slots_all[pos:pos + n]
                if not seg_valid.all():
                    if out_w_l[li] is None:
                        out_w_l[li] = (
                            np.array(w_in_l[li], np.float32)
                            if w_in_l[li] is not None
                            else np.ones((len(values_l[li]),), np.float32))
                    out_w_l[li][s:s + n] = np.where(
                        seg_valid, out_w_l[li][s:s + n], 0.0)
                pos += n
        new_kjts = [
            kjt.with_values(
                torch.from_numpy(out).to(kjt.values().dtype),
                None if w is None else torch.from_numpy(w))
            for kjt, out, w in zip(kjts, out_l, out_w_l)]
        self._pending_io_groups += 1
        return new_kjts, ios

    # -- device IO ---------------------------------------------------------

    def _check_plan(self, dmp, tname: str) -> None:
        if tname in self._plan_checked:
            return
        ps = dmp.sharded_ebc.plan.get(tname)
        if ps is not None and not (
                ps.sharding_type in (ShardingType.TABLE_WISE,
                                     ShardingType.DATA_PARALLEL)
                and ps.num_col_shards == 1):
            raise ValueError(
                f"tiered cache table {tname} must be TW or DP with a single "
                f"column shard (slot == row); plan has {ps.sharding_type} "
                f"with {ps.num_col_shards} column shards: a write-back would "
                "persist partial rows")
        self._plan_checked.add(tname)

    def write_back(self, dmp, state, tname: str, io: TieredIO) -> None:
        """Gather the evicted slots' packed rows on the current stream and
        write them to the host tier once their copy has completed, in
        pieces of ``_WRITEBACK_ROWS`` (a whole cache's sync reuses one
        bounded pinned buffer)."""
        tbl = self.tables[tname]
        n = len(io.writeback_slots)
        for s in range(0, n, _WRITEBACK_ROWS):
            e = min(s + _WRITEBACK_ROWS, n)
            packed = dmp.gather_row_state_tensor(
                state, tname, io.writeback_slots[s:e], tbl.opt_slots)
            tbl.write_rows(io.writeback_logical[s:e], _to_host(packed))

    def apply_io(self, dmp, state, ios: Dict[str, TieredIO], staged=None):
        """Write evicted rows back to the host tier, then fill the freshly
        assigned slots, all on the current stream.  ``staged``: a
        ``StagedFetch`` from ``TieredPrefetcher.submit(ios)``; rows it
        staged are used as they are, rows it left out (pending
        write-back) are read from the host tier after the write-back."""
        self._pending_io_groups = max(0, self._pending_io_groups - 1)
        for tname, io in ios.items():
            tbl = self.tables[tname]
            self._check_plan(dmp, tname)
            if len(io.writeback_slots):
                # write back FIRST, so a re-fetched evicted id reads its
                # just-persisted trained row
                self.write_back(dmp, state, tname, io)
            if len(io.fetch_slots):
                staged_rows = 0
                vals = None
                if staged is not None:
                    vals, sync_mask = staged.resolve(tname, self.stats)
                    if sync_mask.all():
                        vals = None  # nothing usable was staged
                    elif sync_mask.any():
                        fresh = tbl.read_rows(io.fetch_logical[sync_mask])
                        m = torch.from_numpy(np.flatnonzero(sync_mask))
                        vals[m.to(vals.device)] = torch.from_numpy(
                            fresh).to(vals.device)
                    staged_rows = int((~sync_mask).sum())
                if vals is None:
                    vals = tbl.read_rows(io.fetch_logical)
                sync_rows = len(io.fetch_slots) - staged_rows
                state = dmp.scatter_row_state(state, tname, io.fetch_slots,
                                              vals, tbl.opt_slots)
                self.stats.record_io(tname, fetched=len(io.fetch_slots),
                                     written_back=len(io.writeback_slots),
                                     staged=staged_rows, sync=sync_rows)
            elif len(io.writeback_slots):
                self.stats.record_io(tname, fetched=0,
                                     written_back=len(io.writeback_slots))
        return state

    def reapply_fetches(self, dmp, state, ios_list):
        """Fill the slots of already-applied fetch plans again from the
        host tier, into a state put back to before their step (a revert
        to a saved state also undoes the step's fills, leaving freshly
        claimed slots holding stale rows).  The plans' write-backs reached
        the host tier when they first applied, so this restores the cache
        while the step's own update stays discarded."""
        for ios in ios_list:
            for tname, io in ios.items():
                if not len(io.fetch_slots):
                    continue
                tbl = self.tables[tname]
                state = dmp.scatter_row_state(
                    state, tname, io.fetch_slots,
                    tbl.read_rows(io.fetch_logical), tbl.opt_slots)
        return state

    # -- checkpoint consistency --------------------------------------------

    def sync_to_host(self, dmp, state) -> None:
        """Write EVERY cache-resident row (weights and slots) to the host
        tier without evicting it: the host tier alone then holds the whole
        logical table."""
        for tname, tbl in self.tables.items():
            ids, slots = tbl.resident_items()
            if ids.size == 0:
                continue
            self._check_plan(dmp, tname)
            self.write_back(dmp, state, tname,
                            TieredIO(ids[:0], ids[:0], slots, ids))

    def checkpoint_payload(self, dmp, state) -> Dict[str, Dict]:
        """The host tiers' checkpoint entry, built before the
        checkpoint's atomic commit: sync the cache to the host, publish
        disk tiers durably, and return each table's entry (a disk table
        pins its generation, a RAM table embeds its rows).  Raises
        mid-lookahead: a queued group has claimed slots whose device rows
        still belong to their previous ids, so a sync would persist wrong
        rows under the new claims and lose the old ones' pending
        write-backs."""
        if self._pending_io_groups:
            raise RuntimeError(
                f"checkpoint requested mid-lookahead: "
                f"{self._pending_io_groups} remapped batch group(s) have "
                "cache IO that has not been applied, so the resident map "
                "runs ahead of the device and the synced host tier would be "
                "inconsistent.  Quiesce first: TieredTrainPipeline.drain() "
                "before Checkpointer.save.")
        self.sync_to_host(dmp, state)
        out: Dict[str, Dict] = {}
        for tname, tbl in self.tables.items():
            out[tname] = tbl.checkpoint_state()
            self.stats.record_flush(tname)
        return out

    def checkpoint_restore(self, payload: Optional[Dict[str, Dict]]) -> None:
        """Load the host tiers from a checkpoint and reset every cache map
        (a cold cache).  A resumed run is bit-exact with the uninterrupted
        one: placement never changes a row's value, and every first touch
        fetches the synced host row."""
        if payload is None:
            raise ValueError(
                "checkpoint has no tiered-storage payload: it was saved "
                "without the tiered collection wired into the Checkpointer "
                "(tiered=...)")
        missing = set(self.tables) - set(payload)
        if missing:
            raise ValueError(
                f"checkpoint is missing tiered tables {sorted(missing)}")
        for tname, tbl in self.tables.items():
            tbl.restore_checkpoint_state(payload[tname])
        # the reset erased every claim, the queued remaps' too
        self._pending_io_groups = 0

    def flush(self) -> Dict[str, Optional[int]]:
        """Publish every table's host tier durably; table -> generation
        (None for a RAM tier)."""
        out = {}
        for tname, tbl in self.tables.items():
            out[tname] = tbl.flush()
            self.stats.record_flush(tname)
        return out

    def scalar_metrics(self, prefix: str = "tiered") -> Dict[str, float]:
        """The cache and IO counters, flat under
        ``<prefix>/<table>/<counter>``, and each gating vocabulary's
        ``vocab/*`` counters."""
        out = self.stats.scalar_metrics(prefix)
        for v in self.vocab.values():
            out.update(v.scalar_metrics())
        return out

    def logical_table_weights(self, dmp, state) -> Dict[str, np.ndarray]:
        """Each table's WHOLE logical weights: the host tier overlaid with
        the live values of the cache-resident rows."""
        return {t: self.logical_table_rows(dmp, state, t)[:, :tbl.embedding_dim]
                for t, tbl in self.tables.items()}

    def logical_table_rows(self, dmp, state, tname: str) -> np.ndarray:
        """One table's WHOLE logical packed rows (weights and slots): the
        host tier overlaid with the cache-resident rows."""
        tbl = self.tables[tname]
        rows = tbl.host_rows_view()
        ids, slots = tbl.resident_items()
        if ids.size:
            rows[ids] = dmp.gather_row_state(state, tname, slots,
                                             tbl.opt_slots)
        return rows


def _empty_io() -> TieredIO:
    e = np.zeros((0,), np.int64)
    return TieredIO(e, e, e, e)


def tiered_tables_from_plan(
    plan,
    table_configs,
    fused_config,
    storage_dir: Optional[str] = None,
    host_budget_rows: Optional[Dict[str, int]] = None,
    eviction_policy: str = "lfu_aged",
    default_load_factor: Optional[float] = None,
    init_fns: Optional[Dict[str, object]] = None,
    seed: int = 0,
) -> Dict[str, TieredTable]:
    """A :class:`TieredTable` for every FUSED_HOST_CACHED table of a plan,
    sized by its planned cache load factor, its slots packed from the
    fused optimizer's config; ``table_configs`` give the LOGICAL rows."""
    import os

    from torchrec_tpu_torch.modules.host_offload import cache_rows_from_plan
    from torchrec_tpu_torch.tiered.storage import opt_slot_widths

    rows = {c.name: c.num_embeddings for c in table_configs}
    dims = {c.name: c.embedding_dim for c in table_configs}
    cache_rows = cache_rows_from_plan(plan, rows, default_load_factor)
    out: Dict[str, TieredTable] = {}
    for name, n_cache in cache_rows.items():
        path = (os.path.join(storage_dir, f"{name}.tier")
                if storage_dir is not None else None)
        out[name] = TieredTable(
            name, rows[name], dims[name], n_cache,
            opt_slots=opt_slot_widths(fused_config, dims[name]),
            host_budget_rows=(host_budget_rows or {}).get(name),
            storage_path=path, eviction_policy=eviction_policy,
            init_fn=(init_fns or {}).get(name), seed=seed)
    return out
