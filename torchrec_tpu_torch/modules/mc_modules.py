"""Managed collision (ZCH): zero-collision hashing of unbounded ids
(``torchrec_tpu/modules/mc_modules.py``).

The id -> slot remap is pointer-chasing hash-map work, so it runs on the
host in the input pipeline, on the host library's native transformers
(``inference/serving.py``: ``IdTransformer`` LRU, ``LfuIdTransformer``
LFU / DistanceLFU, ``MpIdTransformer`` multi-probe), the same C++ the JAX
package runs, so the same stream gives the same slots and evictions.  The
card never sees an out-of-range row.  Each batch reports its evictions
(:class:`Eviction`) so the train loop can reset the evicted rows
(:func:`reset_evicted_rows`, an index copy on the table's device) or
write them back to a parameter server first
(``dynamic/kv_store.py::ParameterServer``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.inference.serving import (
    IdTransformer,
    LfuIdTransformer,
    MpIdTransformer,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils.profiling import counter_key


@dataclasses.dataclass
class Eviction:
    """Rows whose ids were evicted this batch (for a row reset or a
    parameter-server flush)."""

    table: str
    global_ids: np.ndarray  # [k] evicted raw ids
    slots: np.ndarray  # [k] table rows they occupied


class MCHManagedCollisionModule:
    """Zero-collision remapper of one table.

    ``eviction_policy``: ``"lru"`` (global LRU), ``"lfu"`` (minimum count,
    LRU within a count), ``"distance_lfu"`` (minimum ``count /
    distance^decay``) or ``"multi_probe"`` (a hash-derived window of
    ``max_probe`` slots an id, LRU within it)."""

    def __init__(
        self,
        zch_size: int,
        table_name: str = "",
        eviction_policy: str = "lru",
        max_probe: int = 8,
        decay_exponent: float = 1.0,
    ):
        self.zch_size = zch_size
        self.table_name = table_name
        if eviction_policy == "multi_probe":
            self._transformer = MpIdTransformer(zch_size, max_probe)
        elif eviction_policy in ("lfu", "distance_lfu"):
            self._transformer = LfuIdTransformer(
                zch_size, eviction_policy, decay_exponent)
        else:
            assert eviction_policy == "lru", eviction_policy
            self._transformer = IdTransformer(zch_size)
        # cumulative counters: every lookup HITS a resident id or INSERTS
        # it; an insert that displaced a live id is a COLLISION and the
        # displaced id an EVICTION (equal for these transformers)
        self.lookup_count = 0
        self.hit_count = 0
        self.insert_count = 0
        self.collision_count = 0
        self.eviction_count = 0

    def remap(self, ids: np.ndarray) -> Tuple[np.ndarray, Optional[Eviction]]:
        """Raw int64 ids -> (slots [n] int64, this batch's eviction or
        None).  A batch whose distinct ids exceed the table raises."""
        ids = np.ascontiguousarray(ids, np.int64)
        # two live ids would share a slot this step; only a batch longer
        # than the table can overflow, so only it pays the unique()
        if len(ids) > self.zch_size:
            n_unique = len(np.unique(ids))
            if n_unique > self.zch_size:
                raise ValueError(
                    f"table {self.table_name}: batch working set "
                    f"({n_unique} distinct ids) exceeds zch_size "
                    f"{self.zch_size}")
        occ_before = len(self._transformer)
        slots, ev_g, ev_s = self._transformer.transform(ids)
        # inserts = occupancy growth + refilled evicted slots
        inserts = len(self._transformer) - occ_before + len(ev_g)
        self.lookup_count += len(ids)
        self.insert_count += inserts
        self.hit_count += len(ids) - inserts
        self.eviction_count += len(ev_g)
        self.collision_count += len(ev_g)
        ev = None
        if len(ev_g):
            ev = Eviction(self.table_name, ev_g, ev_s)
        return slots, ev

    @property
    def occupancy(self) -> int:
        return len(self._transformer)

    def scalar_metrics(self, prefix: str = "mch") -> Dict[str, float]:
        """Flat per-table counters under ``<prefix>/<table>/<counter>``."""
        t = self.table_name or "table"
        out = {
            counter_key(prefix, t, "lookup_count"): float(self.lookup_count),
            counter_key(prefix, t, "hit_count"): float(self.hit_count),
            counter_key(prefix, t, "insert_count"): float(self.insert_count),
            counter_key(prefix, t, "collision_count"): float(
                self.collision_count),
            counter_key(prefix, t, "eviction_count"): float(
                self.eviction_count),
            counter_key(prefix, t, "occupancy"): float(self.occupancy),
            counter_key(prefix, t, "occupancy_rate"): (
                float(self.occupancy) / max(1, self.zch_size)),
        }
        if self.lookup_count:
            out[counter_key(prefix, t, "hit_rate")] = (
                self.hit_count / self.lookup_count)
        return out


class ManagedCollisionCollection:
    """Remappers keyed by feature name (the features of one table share
    its module)."""

    def __init__(self, modules: Dict[str, MCHManagedCollisionModule]):
        self.modules = dict(modules)

    def remap_packed(
        self,
        keys: Sequence[str],
        values: np.ndarray,  # RAW int64, key-major packing
        lengths: np.ndarray,  # [F * B]
    ) -> Tuple[np.ndarray, List[Eviction]]:
        """Remap a raw packed id buffer before the KJT is built: key ``f``'s
        ids are the next ``sum(lengths[f * B:(f + 1) * B])`` values."""
        values = np.ascontiguousarray(values, np.int64)
        F = len(keys)
        B = lengths.shape[0] // F
        per_key = np.asarray(lengths).reshape(F, B).sum(axis=1)
        out = values.copy()
        evictions: List[Eviction] = []
        pos = 0
        for f, key in enumerate(keys):
            n = int(per_key[f])
            mod = self.modules.get(key)
            if mod is not None and n:
                remapped, ev = mod.remap(values[pos:pos + n])
                out[pos:pos + n] = remapped
                if ev is not None:
                    evictions.append(ev)
            pos += n
        return out, evictions

    def remap_kjt(
        self, kjt: KeyedJaggedTensor
    ) -> Tuple[KeyedJaggedTensor, List[Eviction]]:
        """Remap a built KJT feature by feature (its values carry int64
        ids whole: the port's KJT keeps their dtype); the result is on the
        KJT's device."""
        values = kjt.values().detach().cpu().numpy().astype(np.int64)
        lens = kjt.lengths().detach().cpu().numpy()
        lo, co = kjt._length_offsets(), kjt.cap_offsets()
        new_values = values.copy()
        evictions: List[Eviction] = []
        for f, key in enumerate(kjt.keys()):
            mod = self.modules.get(key)
            if mod is None:
                continue
            n = int(lens[lo[f]:lo[f + 1]].sum())
            if n == 0:
                continue
            s = co[f]
            remapped, ev = mod.remap(values[s:s + n])
            new_values[s:s + n] = remapped
            if ev is not None:
                evictions.append(ev)
        out = torch.from_numpy(new_values).to(
            device=kjt.values().device, dtype=kjt.values().dtype)
        return kjt.with_values(out), evictions

    def scalar_metrics(self, prefix: str = "mch") -> Dict[str, float]:
        """Every table's counters (a table's features share one module, so
        each table reports once)."""
        out: Dict[str, float] = {}
        seen = set()
        for mod in self.modules.values():
            if id(mod) in seen:
                continue
            seen.add(id(mod))
            out.update(mod.scalar_metrics(prefix))
        return out


def reset_evicted_rows(
    table: torch.Tensor,
    slots,
    init_fn: Optional[Callable[[Tuple[int, int]], torch.Tensor]] = None,
) -> torch.Tensor:
    """Zero (or re-init with ``init_fn(shape)``) the rows of evicted ids,
    in place, by one index copy on the table's device, and return the
    table; slots outside the table are dropped."""
    slots = torch.as_tensor(np.asarray(slots, np.int64), device=table.device)
    slots = slots[(slots >= 0) & (slots < table.shape[0])]
    shape = (slots.numel(), table.shape[1])
    if init_fn is None:
        fresh = torch.zeros(shape, dtype=table.dtype, device=table.device)
    else:
        fresh = torch.as_tensor(init_fn(shape)).to(table.device, table.dtype)
    with torch.no_grad():
        table.index_copy_(0, slots, fresh)
    return table


class ManagedCollisionEmbeddingBagCollection(nn.Module):
    """Managed collision in front of an embedding collection: remap on the
    host, then look up on the card.  ``apply_fn`` is the collection (an
    ``EmbeddingBagCollection``, registered as a submodule) or any callable
    of a KJT; the evictions of the last call are in ``last_evictions``."""

    def __init__(self, collection: ManagedCollisionCollection, apply_fn):
        super().__init__()
        self.collection = collection
        self.apply_fn = apply_fn
        self.last_evictions: List[Eviction] = []

    def forward(self, kjt: KeyedJaggedTensor):
        """Remap the KJT, then apply the wrapped collection."""
        remapped, evictions = self.collection.remap_kjt(kjt)
        self.last_evictions = evictions
        return self.apply_fn(remapped)

    def scalar_metrics(self, prefix: str = "mch") -> Dict[str, float]:
        return self.collection.scalar_metrics(prefix)


class ManagedCollisionEmbeddingCollection(
    ManagedCollisionEmbeddingBagCollection
):
    """The sequence variant: ``apply_fn`` is an ``EmbeddingCollection``
    returning ``Dict[str, JaggedTensor]``."""
