"""The production pipeline's touched-row ledger
(``torchrec_tpu/parallel/production.py``, ``TouchedRowTracker`` and its
two host all-gathers).

:class:`TouchedRowTracker` collects each table's distinct touched ids
between checkpoints, from the pipelines' per-key valid-id scan
(``TrainPipelineSparseDist.attach_touched_rows``), and hands
``DeltaPublisher`` the rows of those ids at each checkpoint
(``FaultTolerantTrainLoop.attach_delta_publisher``).  The rest of the
module, the composed ``ProductionPipelineConfig`` and its host-sharded
pipeline, is ROADMAP A14.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


class TouchedRowTracker:
    """Distinct-touched-row ledger feeding ``DeltaPublisher``.

    ``record(table, ids)`` accumulates a table's valid ids (host ints);
    ``feature_info`` maps feature -> (table, row_bytes), as the
    pipelines' kernel-traffic scan takes it; ``exclude`` names tables to
    skip (tiered tables, whose ids are cache slots and whose rows ride the
    checkpoint's tier flush).

    :meth:`drain` reads only the drained rows, on the card
    (``DistributedModelParallel.gather_row_state``: each row from the
    rank that holds it), where the JAX package reads them out of whole
    host copies of the tables.  Across ranks the id sets are unioned
    first, so every rank publishes the same ``(ids, rows)``."""

    def __init__(
        self,
        feature_info: Optional[Mapping[str, Tuple[str, int]]] = None,
        exclude: Sequence[str] = (),
    ):
        self._info = dict(feature_info or {})
        self._exclude = frozenset(exclude)
        self._touched: Dict[str, set] = {}
        self.total_recorded = 0

    def record(self, table: str, ids) -> None:
        """Accumulate one table's valid-id stream (host ints)."""
        if table in self._exclude:
            return
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            return
        s = self._touched.setdefault(table, set())
        before = len(s)
        s.update(np.unique(ids).tolist())
        self.total_recorded += len(s) - before

    def pending_rows(self) -> Dict[str, int]:
        """Per-table distinct rows waiting for the next drain."""
        return {t: len(s) for t, s in self._touched.items()}

    def drain(self, dmp, state) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Snapshot and reset: ``{table: (ids ascending, rows [k, D]
        float32)}`` for ``DeltaPublisher.publish``, the rows the live
        post-update weights.  A collective under a process group: every
        rank drains at the same step (the checkpoint cadence)."""
        local = {t: np.asarray(sorted(s), np.int64)
                 for t, s in self._touched.items()}
        self._touched = {}
        if dist.is_initialized() and dist.get_world_size() > 1:
            tables = sorted(set().union(
                *(set(w) for w in _allgather_object_keys(local))))
            local = {t: _allgather_varlen_ids(
                local.get(t, np.zeros((0,), np.int64))) for t in tables}
        if not any(ids.size for ids in local.values()):
            return {}
        out = {}
        for t, ids in local.items():
            if ids.size:
                out[t] = (ids, _weight_rows(dmp, state, t, ids))
        return out


def _weight_rows(dmp, state, table: str, ids: np.ndarray) -> np.ndarray:
    """``[k, D]`` float32 rows of ``table`` at ``ids``: gathered on the
    card (``gather_row_state``) for a table held in one column shard, else
    read out of the whole table (``table_weights``)."""
    ps = dmp.plan.get(table)
    if ps is None or ps.num_col_shards == 1:
        return dmp.gather_row_state(state, table, ids)
    return np.asarray(dmp.table_weights(state)[table][ids], np.float32)


def _allgather_object_keys(local: Dict[str, Any]) -> List[List[str]]:
    """Every rank's table-name list (a fixed-width encoded host all-gather;
    a rank that saw no batch of a table still takes part)."""
    from torchrec_tpu_torch.parallel.multiprocess import allgather_host

    names = sorted(local)
    joined = ",".join(names)
    buf = np.zeros((256,), np.uint8)
    raw = joined.encode()[:256]
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    g = allgather_host(buf)
    out = []
    for row in g:
        s = bytes(row[row != 0]).decode()
        out.append([n for n in s.split(",") if n])
    return out


def _allgather_varlen_ids(ids: np.ndarray) -> np.ndarray:
    """The distinct union of a variable-length id set across ranks: gather
    the counts, pad to the largest, gather the payload."""
    from torchrec_tpu_torch.parallel.multiprocess import allgather_host

    counts = allgather_host(np.asarray([ids.size], np.int64))[:, 0]
    m = max(1, int(counts.max()))
    buf = np.full((m,), -1, np.int64)
    buf[:ids.size] = ids
    g = allgather_host(buf)
    vals = np.concatenate(
        [g[p, :int(counts[p])] for p in range(len(counts))]
        or [np.zeros((0,), np.int64)])
    return np.unique(vals)
