"""Sharding-plan types (a subset of ``torchrec_tpu/parallel/types.py``):
the enums, ``ShardMetadata``, ``ParameterSharding`` and ``ShardingPlan``
with the JAX package's names and values, the plan dict, the planner's
``StampedEmbeddingModuleShardingPlan``, and :func:`table_wise_plan`, the
plan the planner gives a one-device world.

What the runtime does with the planner's fields: a FUSED_HOST_CACHED
table raises ``NotImplementedError`` (tiered storage, ROADMAP A10) in
``classify_plan``; ``dedup`` on a ROW_WISE table compiles the dedup'd
row-wise dist, its capacity sized by ``dedup_factor``; ``hier`` on a
row-wise or block-shard table compiles the two-level ICI/DCN dists on a
two-level world (``comm.ShardingEnv`` with ``num_slices``), their
capacity sized by ``hier_factor``, and is ignored on a flat one, as in
the JAX runtime; ``cache_load_factor`` sizes what the host-cached path
would build.
:class:`ShardingStrategy` is the weight strategy of 2D parallelism
(``DMPCollection``).
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


class ShardingStrategy(enum.Enum):
    """The 2D-parallel weight strategy of ``DMPCollection``.  REPLICATED:
    each replica holds its own copy of every sharded table, the copies
    averaged by a periodic sync.  FULLY_SHARDED: tables and their fused
    optimizer state are split over the replicas too, gathered for the
    forward, every replica's gradients applied to each slice every step
    (1 / R the memory, replicas always in step)."""

    REPLICATED = "replicated"
    FULLY_SHARDED = "fully_sharded"


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
    a caller records it, ``cache_load_factor`` the device cache of a
    FUSED_HOST_CACHED table as a fraction of its rows.  ``dedup`` asks
    for the row-wise dedup'd input dist, ``dedup_factor`` its expected
    duplication (1.0: exact); ``hier`` for the two-level dists of a
    row-wise or block-shard table, ``hier_factor`` their cross-node
    capacity (module docstring)."""

    sharding_type: ShardingType
    compute_kernel: EmbeddingComputeKernel = EmbeddingComputeKernel.FUSED
    ranks: Optional[List[int]] = None
    sharding_spec: Optional[List[ShardMetadata]] = None
    num_col_shards: int = 1
    cache_load_factor: Optional[float] = None
    dedup: bool = False
    dedup_factor: float = 1.0
    hier: bool = False
    hier_factor: float = 1.0


# the FUSED_HOST_CACHED device-cache fraction when none is given: the
# planner's storage model and a cache's sizing must agree on it
DEFAULT_CACHE_LOAD_FACTOR = 0.2


# table name -> ParameterSharding
EmbeddingModuleShardingPlan = Dict[str, ParameterSharding]


class StampedEmbeddingModuleShardingPlan(Dict[str, ParameterSharding]):
    """An ``EmbeddingModuleShardingPlan`` carrying the planner's plan-time
    beliefs, ``assumptions`` (an ``obs.assumptions.PlanAssumptions``, or
    None): per-table expected occupancy, padding efficiency, cache hit
    rate and duplication, and the expected wire bytes a step.  A plain
    dict subclass, so every consumer of a plan takes it."""

    def __init__(self, mapping=(), assumptions=None):
        super().__init__(mapping)
        self.assumptions = assumptions


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
