"""Sharding-plan types (a subset of ``torchrec_tpu/parallel/types.py``):
the enums, ``ShardMetadata``, ``ParameterSharding`` and ``ShardingPlan``
with the JAX package's names and values, the plan dict, and
:func:`table_wise_plan`, the plan the JAX planner gives a one-device
world.

Left out: ``ShardingStrategy`` (2D parallelism), the dedup factor, the
hier and cache fields of ``ParameterSharding`` and
``StampedEmbeddingModuleShardingPlan``.  The planner waits for the next
slice of ROADMAP A6 (with A4): the port's ``DistributedModelParallel``
takes its plan as an argument.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig


class ShardingType(enum.Enum):
    """The seven sharding types."""

    DATA_PARALLEL = "data_parallel"
    TABLE_WISE = "table_wise"
    COLUMN_WISE = "column_wise"
    ROW_WISE = "row_wise"
    TABLE_ROW_WISE = "table_row_wise"
    TABLE_COLUMN_WISE = "table_column_wise"
    GRID_SHARD = "grid_shard"


class EmbeddingComputeKernel(enum.Enum):
    """DENSE: dense-gradient path; FUSED: fused sparse optimizer (the
    default); QUANT: int8 inference; FUSED_HOST_CACHED: host-offloaded
    table with a device cache."""

    DENSE = "dense"
    FUSED = "fused"
    QUANT = "quant"
    FUSED_HOST_CACHED = "fused_host_cached"


@dataclasses.dataclass
class ShardMetadata:
    """One shard of a table: ``shard_offsets`` (row, col) origin,
    ``shard_sizes`` (rows, cols) extent, ``placement`` its rank."""

    shard_offsets: Tuple[int, int]
    shard_sizes: Tuple[int, int]
    placement: int


@dataclasses.dataclass
class ParameterSharding:
    """How one table is laid out: ``sharding_type`` picks the split,
    ``ranks`` the placement (TW: ``[rank]``; CW/TWCW: one rank per column
    shard; TWRW: the node's contiguous ranks; GRID: the nodes of the
    column shards one after another; RW/DP: all ranks), ``num_col_shards``
    the CW/GRID split count, ``sharding_spec`` the shards' geometry where
    a caller records it.  ``dedup`` asks for the row-wise dedup'd input
    dist, which is not ported (ROADMAP A7): ``classify_plan`` raises on
    it."""

    sharding_type: ShardingType
    compute_kernel: EmbeddingComputeKernel = EmbeddingComputeKernel.FUSED
    ranks: Optional[List[int]] = None
    sharding_spec: Optional[List[ShardMetadata]] = None
    num_col_shards: int = 1
    dedup: bool = False


# table name -> ParameterSharding
EmbeddingModuleShardingPlan = Dict[str, ParameterSharding]


@dataclasses.dataclass
class ShardingPlan:
    """module path -> per-table plan."""

    plan: Dict[str, EmbeddingModuleShardingPlan]

    def get_plan_for_module(
        self, module_path: str
    ) -> Optional[EmbeddingModuleShardingPlan]:
        return self.plan.get(module_path)


def table_wise_plan(
    tables: Sequence[EmbeddingBagConfig], rank: int = 0
) -> EmbeddingModuleShardingPlan:
    """Every table ``TABLE_WISE`` on ``rank`` with the fused kernel: what
    ``EmbeddingShardingPlanner(world_size=1).plan(tables)`` returns."""
    return {
        c.name: ParameterSharding(ShardingType.TABLE_WISE,
                                  EmbeddingComputeKernel.FUSED, [rank])
        for c in tables
    }
