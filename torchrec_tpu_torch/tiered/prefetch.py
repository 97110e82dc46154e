"""Asynchronous prefetch for tiered embedding storage
(``torchrec_tpu/tiered/prefetch.py``).

While step ``i`` runs, the remap of a later batch has already given its
fetch plan (its distinct new ids).  One background worker reads those
packed rows out of the host or disk tier into a pinned host buffer and
copies them to the card on a side CUDA stream, recording an event;
``TieredCollection.apply_io`` makes the step's stream wait for that event
before it scatters the rows into the cache.  The last serial work in
front of a step is then the scatter itself.

Why a staged row is never stale:

* remaps run in stream order on the pipeline thread; only host-tier
  READS are staged;
* a fetch id with a PENDING write-back (its own batch's, or that of any
  earlier batch remapped but not applied yet) is left out of the stage
  and read after that write-back has landed (``apply_io``); every other
  host row is written only by write-backs of ids that rule covers, so
  the worker's reads and the pipeline's writes touch different rows;
* the pinned buffers are a ring of two a table, each refilled only after
  the event of its last copy has completed; the device rows a stage
  copies into are allocated on the side stream and marked as used by the
  step's stream (``record_stream``) when it consumes them.

On the CPU (a ``device="cpu"`` pipeline) the worker reads into host
tensors and no stream is involved.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.obs.spans import span as obs_span
from torchrec_tpu_torch.tiered.storage import TieredIO
from torchrec_tpu_torch.utils.profiling import TieredStats

_RING = 2  # pinned buffers a table


class StagedFetch:
    """One batch group's staged fetch rows: ``ios`` its per-table plans,
    ``future`` resolving to table -> (rows ``[k, row_width]`` on the
    device, the event of their copy or None), ``sync_masks`` the rows left
    out of the stage (pending write-back) that must be read after it."""

    def __init__(self, ios: Dict[str, TieredIO],
                 sync_masks: Dict[str, np.ndarray],
                 future: Optional[Future]):
        self._ios = ios
        self._sync_masks = sync_masks
        self._future = future
        self._values: Optional[Dict[str, Tuple[torch.Tensor, object]]] = None

    def resolve(self, table: str, stats: Optional[TieredStats] = None):
        """(rows, sync_mask) of a table's fetch plan, the rows usable on
        the current stream; rows where ``sync_mask`` is True were not
        staged and hold garbage (the caller reads them).  Blocks on the
        worker: the blocked time is the prefetch's non-overlapped part."""
        if self._values is None:
            if self._future is None:
                self._values = {}
            else:
                # the span carries the interval that goes to record_wait,
                # so the span-derived overlap (``obs report``) is
                # TieredStats.prefetch_overlap_ratio to the float
                with obs_span("tiered/prefetch_wait") as sp:
                    t0 = time.perf_counter()
                    self._values = self._future.result()
                    dt = time.perf_counter() - t0
                    if stats is not None:
                        stats.record_wait(dt)
                    sp.set_attr("seconds", dt)
        k = len(self._ios[table].fetch_logical)
        mask = self._sync_masks.get(table, np.ones((k,), bool))
        got = self._values.get(table)
        if got is None:
            return None, np.ones((k,), bool)
        vals, ready = got
        if ready is not None:
            # the step's stream waits for the side stream's copy, and the
            # rows' memory is not reused before the step's stream is done
            cur = torch.cuda.current_stream(vals.device)
            cur.wait_event(ready)
            vals.record_stream(cur)
        return vals, mask


class TieredPrefetcher:
    """Stages host-tier reads of queued batches on one background worker
    (stages run in submission order and never interleave; the tables'
    locks order them against the pipeline's write-backs).  ``device``:
    where staged rows go (the DMP's; a CUDA device copies on a side
    stream).  Wait and stage times go to ``stats`` (the collection's by
    default)."""

    def __init__(self, collection, stats: Optional[TieredStats] = None,
                 device=None):
        self._coll = collection
        self.stats = stats if stats is not None else collection.stats
        self.device = torch.device("cpu" if device is None else device)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="tiered-prefetch")
        self._lock = threading.Lock()
        # submitted-but-unapplied plans, in stream order: their write-back
        # sets say which fetch rows are unsafe to stage
        self._pending: List[Dict[str, TieredIO]] = []
        # CUDA only: the side stream, and per table a ring of (pinned
        # buffer, event of its last copy)
        self._side = None
        self._ring: Dict[str, List[list]] = {}
        self._turn: Dict[str, int] = {}

    def submit(self, ios: Dict[str, TieredIO]) -> StagedFetch:
        """Start staging a group's fetch rows; called in stream order right
        after ``TieredCollection.process_group``."""
        plan: Dict[str, np.ndarray] = {}
        sync_masks: Dict[str, np.ndarray] = {}
        with self._lock:
            for tname, io in ios.items():
                if not len(io.fetch_logical):
                    continue
                unsafe = [io.writeback_logical]
                for prev in self._pending:
                    p = prev.get(tname)
                    if p is not None and len(p.writeback_logical):
                        unsafe.append(p.writeback_logical)
                sync = np.isin(io.fetch_logical, np.concatenate(unsafe))
                sync_masks[tname] = sync
                if (~sync).any():
                    plan[tname] = sync
            self._pending.append(ios)
        future = self._pool.submit(self._stage, ios, plan) if plan else None
        return StagedFetch(ios, sync_masks, future)

    def _pinned(self, tname: str, rows: int, width: int) -> list:
        """The next pinned buffer of a table's ring with room for
        ``rows``, after its last copy completed."""
        ring = self._ring.setdefault(tname, [[None, None]
                                             for _ in range(_RING)])
        i = self._turn.get(tname, 0)
        self._turn[tname] = (i + 1) % _RING
        slot = ring[i]
        if slot[1] is not None:
            slot[1].synchronize()
        if slot[0] is None or slot[0].shape[0] < rows or (
                slot[0].shape[1] != width):
            slot[0] = torch.empty((max(rows, 1), width), dtype=torch.float32,
                                  pin_memory=True)
        return slot

    def _stage(self, ios: Dict[str, TieredIO], plan: Dict[str, np.ndarray]):
        # the span carries the record_stage interval (see resolve)
        with obs_span("tiered/prefetch_stage") as sp:
            t0 = time.perf_counter()
            out = (self._stage_cuda(ios, plan) if self.device.type == "cuda"
                   else self._stage_host(ios, plan))
            dt = time.perf_counter() - t0
            self.stats.record_stage(dt)
            sp.set_attr("seconds", dt)
            return out

    def _stage_host(self, ios, plan):
        out = {}
        for tname, sync in plan.items():
            tbl = self._coll.tables[tname]
            io = ios[tname]
            vals = np.empty((len(io.fetch_logical), tbl.row_width),
                            np.float32)
            vals[~sync] = tbl.read_rows(io.fetch_logical[~sync])
            out[tname] = (torch.from_numpy(vals), None)
        return out

    def _stage_cuda(self, ios, plan):
        dev = self.device
        if self._side is None:
            self._side = torch.cuda.Stream(device=dev)
        out, used = {}, []
        with torch.cuda.device(dev), torch.cuda.stream(self._side):
            for tname, sync in plan.items():
                tbl = self._coll.tables[tname]
                io = ios[tname]
                keep = np.flatnonzero(~sync)
                slot = self._pinned(tname, keep.size, tbl.row_width)
                host = slot[0][:keep.size]
                tbl.read_rows(io.fetch_logical[keep], out=host.numpy())
                rows = host.to(dev, non_blocking=True)
                if keep.size != len(io.fetch_logical):
                    vals = torch.empty((len(io.fetch_logical),
                                        tbl.row_width), dtype=torch.float32,
                                       device=dev)
                    vals[torch.from_numpy(keep).to(dev)] = rows
                else:
                    vals = rows
                out[tname] = vals
                used.append(slot)
            ready = torch.cuda.Event()
            ready.record(self._side)
        for slot in used:
            slot[1] = ready
        return {t: (v, ready) for t, v in out.items()}

    def invalidate(self) -> None:
        """Forget every submitted-but-unapplied stage (the pipeline dropped
        its queued entries after a rollback or a resume)."""
        with self._lock:
            self._pending.clear()

    def mark_applied(self, ios: Dict[str, TieredIO]) -> None:
        """Drop a group's write-back sets from the unsafe window once
        ``apply_io`` landed them in the host tier."""
        with self._lock:
            for i, p in enumerate(self._pending):
                if p is ios:
                    del self._pending[i]
                    return

    def settle(self) -> None:
        """Block until every stage submitted so far has finished (its
        timing recorded and its span closed)."""
        self._pool.submit(lambda: None).result()

    def close(self) -> None:
        self._pool.shutdown(wait=True)
