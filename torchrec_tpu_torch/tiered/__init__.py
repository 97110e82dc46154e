"""Tiered embedding storage (``torchrec_tpu/tiered``): a card-resident
cache over host-RAM and disk tiers, with asynchronous prefetch.  A table
too large for the card trains through :class:`TieredTrainPipeline`: its
ids are remapped to cache slots on the host (:class:`TieredCollection`
over :class:`TieredTable`), evicted rows are written back and new rows
filled packed with their optimizer slots, so the run is bit-exact with
an all-card run."""

from torchrec_tpu_torch.tiered.collection import (
    TieredCollection,
    tiered_tables_from_plan,
)
from torchrec_tpu_torch.tiered.pipeline import TieredTrainPipeline
from torchrec_tpu_torch.tiered.prefetch import StagedFetch, TieredPrefetcher
from torchrec_tpu_torch.tiered.storage import (
    DiskStore,
    HostRamCache,
    RamStore,
    TieredIO,
    TieredTable,
    opt_slot_widths,
    plan_cache_io,
)

__all__ = [
    "DiskStore",
    "HostRamCache",
    "RamStore",
    "StagedFetch",
    "TieredCollection",
    "TieredIO",
    "TieredPrefetcher",
    "TieredTable",
    "TieredTrainPipeline",
    "opt_slot_widths",
    "plan_cache_io",
    "tiered_tables_from_plan",
]
