"""Storage reservations — carve non-embedding memory out of the budget
BEFORE the partitioner places tables.

Reference: ``planner/storage_reservations.py`` —
``FixedPercentageStorageReservation`` (:123) and
``HeuristicalStorageReservation`` (:435: percentage overhead + dense
tensor storage + KJT input storage, all subtracted from each device).

Accounting: dense params are replicated per device and optimizers keep
1-2 slots, so dense cost = params x (1 + grad + slots); KJT buffers are
the static-capacity regions (ids int32 + weights fp32 + lengths), double-
buffered under async prefetch; the percentage covers scratch,
activations, and fragmentation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from torchrec_tpu_torch.parallel.planner.types import Storage, Topology


@dataclasses.dataclass
class FixedPercentageStorageReservation:
    """Reserve a flat fraction of HBM (reference :123)."""

    percentage: float = 0.15

    def reserve(self, topology: Topology, **kwargs) -> Topology:
        for d in topology.devices:
            d.storage = Storage(
                hbm=int(d.storage.hbm * (1 - self.percentage)),
                ddr=d.storage.ddr,
            )
        return topology


@dataclasses.dataclass
class HeuristicalStorageReservation:
    """Percentage overhead + dense-model storage + KJT input buffers
    (reference :435).

    ``dense_param_bytes``: total bytes of the replicated dense sub-model's
    parameters.  ``dense_optimizer_slots``: optax slot count (adagrad 1,
    adam 2).  ``feature_caps``/``batch_size_per_device`` size the static
    KJT regions; ``input_double_buffered`` models prefetch pipelines
    holding batch N+1 while N runs."""

    percentage: float = 0.15
    dense_param_bytes: int = 0
    dense_optimizer_slots: int = 1
    feature_caps: Optional[Dict[str, int]] = None
    batch_size_per_device: int = 512
    weighted_features: bool = False
    input_double_buffered: bool = True

    def kjt_bytes(self) -> int:
        if not self.feature_caps:
            return 0
        per_batch = 0
        for cap in self.feature_caps.values():
            per_id = 4 + (4 if self.weighted_features else 0)  # int32 (+w)
            per_batch += cap * per_id + self.batch_size_per_device * 4
        return per_batch * (2 if self.input_double_buffered else 1)

    def dense_bytes(self) -> int:
        # params + grads + optimizer slots, all replicated per chip
        return self.dense_param_bytes * (2 + self.dense_optimizer_slots)

    def reserve(self, topology: Topology, **kwargs) -> Topology:
        fixed = self.dense_bytes() + self.kjt_bytes()
        for d in topology.devices:
            hbm = int(d.storage.hbm * (1 - self.percentage)) - fixed
            if hbm <= 0:
                from torchrec_tpu_torch.parallel.planner.types import PlannerError

                raise PlannerError(
                    f"storage reservation leaves no HBM on rank {d.rank}: "
                    f"cap {d.storage.hbm} - {self.percentage:.0%} overhead "
                    f"- {fixed} dense/KJT bytes"
                )
            d.storage = Storage(hbm=hbm, ddr=d.storage.ddr)
        return topology
