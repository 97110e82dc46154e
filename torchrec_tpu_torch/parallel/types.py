"""Sharding-plan types (a subset of ``torchrec_tpu/parallel/types.py``):
the enums and ``ParameterSharding`` with the JAX package's names and
values, the plan dict, and :func:`table_wise_plan`, the plan the JAX
planner gives a one-device world.

Left out: ``ShardingStrategy``, ``ShardMetadata``, the dedup / hier /
cache fields of ``ParameterSharding``, ``StampedEmbeddingModuleShardingPlan``
and ``ShardingPlan``.  The planner itself waits for multi-GPU sharding
(ROADMAP A6): the port's ``DistributedModelParallel`` takes its plan as an
argument.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence

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
class ParameterSharding:
    """How one table is laid out: ``sharding_type`` picks the split,
    ``ranks`` the placement (TW: ``[rank]``; CW: one rank per column
    shard), ``num_col_shards`` the CW split count."""

    sharding_type: ShardingType
    compute_kernel: EmbeddingComputeKernel = EmbeddingComputeKernel.FUSED
    ranks: Optional[List[int]] = None
    num_col_shards: int = 1


# table name -> ParameterSharding
EmbeddingModuleShardingPlan = Dict[str, ParameterSharding]


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
